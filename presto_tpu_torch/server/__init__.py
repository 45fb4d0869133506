"""The worker tier: HTTP workers, their client, the coordinator that
schedules plan fragments on them, and discovery."""

from .client import WorkerClient
from .coordinator import Coordinator
from .worker import TaskManager, TpuWorkerServer

__all__ = ["TpuWorkerServer", "TaskManager", "WorkerClient", "Coordinator"]
