"""Device execution plans: XLA lowerings of every method."""
from . import xla_csr
