"""A `calc` cell's variant pairs of the window's completed jobs (the
benchmark's own count, from the tile shapes) over the time from the
window's start to the last job's end: what `calc` users and the
reference tool report. A metric of its own beside `pairs_per_s`, for
whole jobs pace on the host and spread more from run to run than the
engine's resident sweep."""


def read(run, res):
    return res["pairs_per_s"]
