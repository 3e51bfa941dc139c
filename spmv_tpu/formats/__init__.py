"""Host-side format conversion and partition planning."""
from . import partition, sell, dia, bcsr, reorder
