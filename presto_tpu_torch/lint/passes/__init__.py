"""The port's tpulint passes. Importing this package registers every
pass with the core registry (core.register decorator side effect); add
a new pass by dropping a module here and importing it below."""

from . import (alloc, blocking, host_sync, lock_order, locks,  # noqa: F401
               retrace, swallowed, threads, wide_lanes)
