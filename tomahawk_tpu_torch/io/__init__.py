from .constants import (
    TWK_MAGIC, TWO_MAGIC, TWOAGG_MAGIC, FILE_EOF, TWOAGG_EOF,
    INDEX_START_MARKER,
)
from .buffer import BufferWriter, BufferReader
from .header import VcfContig, VcfHeader
from .index import IndexEntry, Index, IndexOutput
from .twk import Twk1Record, Twk1Block, TwkWriter, TwkReader
from .two import TWO_DTYPE, TwoWriter, TwoReader, two_records_from_bytes
