"""Plugin lifecycle shell — the counterpart of spark_rapids_tpu/plugin.py
(the reference's Plugin.scala: RapidsDriverPlugin :412 /
RapidsExecutorPlugin :484): start-up validation, device and memory
runtime initialization, and the fatal-error -> exit policy (:640-662: a
fatal CUDA error logs diagnostics and kills the executor so that the
cluster manager reschedules it).

There is no Spark JVM to plug into, so the lifecycle is an explicit
object the embedding application drives:
`TpuExecutorPlugin(conf).init()` … `.shutdown()`. The init order is the
reference's: environment validation (a card of compute capability 9.0
and a torch built with CUDA) -> device and memory runtime
(memory/device_manager: the card, the budget from its free memory and
the confs) -> heartbeats -> admission semaphore. The driver plugin runs
the heartbeat manager (parallel/heartbeat.py); an executor given its
driver registers with it and beats from an endpoint thread, learning its
peers (`peers`), and stops the thread at shutdown.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional

import torch

log = logging.getLogger("spark_rapids_tpu_torch.plugin")

#: the compute capability the kernels are built for (sm_90a)
REQUIRED_CAPABILITY = (9, 0)

#: messages of the CUDA runtime's sticky errors: the context is lost
_FATAL_CUDA = ("illegal memory access", "unspecified launch failure",
               "device-side assert", "misaligned address",
               "illegal instruction", "CUDA error")


class FatalDeviceError(Exception):
    """Unrecoverable device/runtime failure (the reference's
    CudaFatalException classification)."""


class TpuDriverPlugin:
    """Driver side (reference RapidsDriverPlugin.init :412)."""

    def __init__(self, conf=None):
        from .config import RapidsConf, active_conf
        self.conf: RapidsConf = conf or active_conf()
        #: the executors' peer registry, from init()
        self.heartbeat_manager = None

    def init(self) -> "TpuDriverPlugin":
        from .parallel.heartbeat import HeartbeatManager
        self.heartbeat_manager = HeartbeatManager()
        log.info("TpuDriverPlugin initialized (heartbeat manager up)")
        return self

    def shutdown(self) -> None:
        self.heartbeat_manager = None


class TpuExecutorPlugin:
    """Executor side (reference RapidsExecutorPlugin.init :484)."""

    def __init__(self, conf=None, executor_id: str = "exec-0",
                 driver: Optional[TpuDriverPlugin] = None,
                 exit_fn: Callable[[int], None] = None):
        from .config import RapidsConf, active_conf
        self.conf: RapidsConf = conf or active_conf()
        self.executor_id = executor_id
        self.driver = driver
        self.heartbeat_endpoint = None
        self.peers: List[str] = []
        #: test seam: production exits the process like Plugin.scala:655
        self._exit = exit_fn or (lambda code: os._exit(code))
        self._initialized = False

    # -- init sequence (reference order) -----------------------------------
    def init(self) -> "TpuExecutorPlugin":
        from .config import set_active_conf
        set_active_conf(self.conf)
        self._validate_environment()
        self._init_device_and_memory()
        self._init_heartbeats()
        self._init_semaphore()
        self._initialized = True
        log.info("TpuExecutorPlugin %s initialized", self.executor_id)
        return self

    def _validate_environment(self) -> None:
        """Platform checks (reference validateGpuArchitecture +
        checkCudfVersion): a torch built with CUDA and a card of compute
        capability 9.0, the target of the kernels."""
        if torch.version.cuda is None:
            raise FatalDeviceError(
                f"torch {torch.__version__} is built without CUDA")
        if not torch.cuda.is_available():
            raise FatalDeviceError("no CUDA device visible")
        cap = torch.cuda.get_device_capability(0)
        if tuple(cap) != REQUIRED_CAPABILITY:
            raise FatalDeviceError(
                f"{torch.cuda.get_device_name(0)} has compute capability "
                f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a")
        tz = os.environ.get("TZ")
        if tz not in (None, "", "UTC", "Etc/UTC"):
            log.warning("process TZ=%s; the engine computes in UTC", tz)

    def _init_device_and_memory(self) -> None:
        from .memory.device_manager import device_manager
        try:
            device_manager().initialize()
        except Exception as e:  # noqa: BLE001 — classified below
            self.on_fatal_error(e)
            raise

    def _init_heartbeats(self) -> None:
        """Register with the driver's heartbeat manager and beat from an
        endpoint thread (no driver, or a driver without a manager: no
        heartbeats)."""
        if self.driver is None or self.driver.heartbeat_manager is None:
            return
        from .parallel.heartbeat import HeartbeatEndpoint
        self.heartbeat_endpoint = HeartbeatEndpoint(
            self.driver.heartbeat_manager, self.executor_id,
            on_new_peer=lambda p: self.peers.append(p.executor_id))
        self.heartbeat_endpoint.start()

    def _init_semaphore(self) -> None:
        from .memory.semaphore import tpu_semaphore
        tpu_semaphore()

    # -- failure policy ----------------------------------------------------
    def on_fatal_error(self, exc: BaseException) -> None:
        """Reference Plugin.scala:640-662: log device diagnostics, then
        exit the executor so the scheduler replaces it (task retry IS the
        recovery model)."""
        log.error("FATAL device error: %s", exc, exc_info=exc)
        try:
            for i in range(torch.cuda.device_count()):
                log.error("cuda:%d: %s", i, torch.cuda.memory_summary(i))
        except Exception:  # noqa: BLE001 — diagnostics are best-effort
            pass
        if self._classify_fatal(exc):
            log.error("executor %s exiting for reschedule",
                      self.executor_id)
            self._exit(1)

    @staticmethod
    def _classify_fatal(exc: BaseException) -> bool:
        """Which failures kill the executor (reference: CudaFatalException
        yes, retryable OOM no). An allocator OOM on the card takes the
        retry lane (memory/retry.is_oom_error); a sticky CUDA error such
        as an illegal memory access loses the context and is fatal."""
        from .memory.retry import TpuOOMError, is_oom_error
        if isinstance(exc, TpuOOMError) or is_oom_error(exc):
            return False
        if isinstance(exc, FatalDeviceError):
            return True
        if type(exc).__name__ == "AcceleratorError":
            return True
        return isinstance(exc, RuntimeError) and any(
            m in str(exc) for m in _FATAL_CUDA)

    def on_task_failed(self, exc: BaseException) -> None:
        """Reference onTaskFailed: inspect for fatal classification."""
        if self._classify_fatal(exc):
            self.on_fatal_error(exc)

    def shutdown(self) -> None:
        if self.heartbeat_endpoint is not None:
            self.heartbeat_endpoint.stop()
            self.heartbeat_endpoint = None
        from .memory.device_manager import device_manager
        device_manager().shutdown()
        self._initialized = False
