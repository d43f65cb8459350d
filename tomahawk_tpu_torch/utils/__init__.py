from .logging import log, timestamp, pretty_int
from .timer import Timer
