"""The mesh tier: workers over a tuple of devices, the exchanges that
move rows between them, and the distributed stages built on them."""

from .exchange import (broadcast_build, exchange_by_hash, exchange_by_range,
                       gather_to_root)
from .mesh import WORKERS_AXIS, Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "WORKERS_AXIS", "exchange_by_hash",
           "exchange_by_range", "broadcast_build", "gather_to_root"]
