"""Built-in kernaudit passes of the port. Importing this package
registers every pass with the audit registry (core.register side
effect), one module per module of presto_tpu/audit/passes/."""

from . import (collectives, donation, footprint,  # noqa: F401
               host_callback, wide_lanes, widening)
