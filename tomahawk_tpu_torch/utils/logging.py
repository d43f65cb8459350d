"""Timestamped stderr logging, mirroring the reference CLI conventions
(reference: lib/utility.cpp utility::timestamp)."""

import sys
import datetime

SILENT = False


def timestamp(level: str, sub: str = "") -> str:
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S,%f")[:-3]
    tag = f"[{now}][{level}]" if not sub else f"[{now}][{level}][{sub}]"
    return tag + " "


def log(level: str, *msg, sub: str = ""):
    if SILENT:
        return
    print(timestamp(level, sub) + " ".join(str(m) for m in msg),
          file=sys.stderr, flush=True)


def pretty_int(n) -> str:
    return f"{int(n):,}"


def stamp_literals(header, tool: str, detail: str = ""):
    """Append a provenance line to the output header literals, mirroring
    the reference's per-command Version/Command stamps
    (reference: ld.cpp:610-612, importer.cpp:78-80)."""
    import datetime
    from .. import __version__
    header.literals += (f"\n##tomahawk_tpu_torch_{tool}Version={__version__}\n"
                        f"##tomahawk_tpu_torch_{tool}Command={tool} {detail}; "
                        f"Date={datetime.datetime.now().isoformat()}\n")
