"""Utilities: throughput measurements, checkpoints, profiling, monitoring
and health, safety and validation, errors, logging, caching, concurrency
and scaling.

PyTorch counterpart of ``spintorque_tpu/utils``, with the same names
(and the port's measurement programs and env / trainer checkpoints).
Device compute is never cached: the cache stack (``utils/cache.py``) holds
host results. ``PhysicsWorkerPool`` coalesces submitted solves into one
pulse launch, ``AutoScaler`` tunes the env batch size (the card's thread
count), and scale-out across cards is the mesh of
``spintorque_tpu_torch.parallel``.
"""

from .cache import (
    AdaptiveCache,
    CacheManager,
    CacheStats,
    LRUCache,
    cached,
    get_cache_manager,
)

from .benchmark import measure_env_throughput, measure_train_throughput
from .checkpoint import (
    CheckpointManager,
    load_env_state,
    load_params,
    load_pytree,
    load_train_state,
    save_env_state,
    save_params,
    save_pytree,
    save_train_state,
)
from .error_handling import (
    ConfigurationError,
    DeviceError,
    ErrorRecoveryManager,
    NumericalError,
    PhysicsError,
    SpinTorqueError,
    robust_computation,
    safe_division,
    safe_execute,
    safe_log,
    safe_normalize,
    safe_sqrt,
)
from .logging_config import (
    LoggingContext,
    PerformanceLogger,
    StructuredFormatter,
    get_logger,
    setup_logging,
)
from .concurrency import (
    AsyncEnvironmentManager,
    ParallelBenchmark,
    PhysicsWorkerPool,
    ResourcePool,
    parallel_map,
)
from .health import (
    DeviceHealthCheck,
    EnvironmentHealthCheck,
    HealthCheck,
    PhysicsHealthCheck,
    SystemHealthCheck,
    build_full_health_monitor,
    get_health_monitor,
)
from .monitoring import (
    EnvironmentMonitor,
    HealthMonitor,
    MetricsCollector,
    SafetyWrapper,
    default_health_monitor,
)
from .performance import (
    ComputationOptimizer,
    get_optimizer,
    pad_batch,
    unpad_batch,
)
from .profiling import PerformanceProfiler, block_and_time, device_trace
from .scalable_environment import ScalableEnvironmentManager
from .scaling import AdaptiveResourceManager, AutoScaler, LoadBalancer
from .security import (
    InputSanitizer,
    RateLimiter,
    SecureHasher,
    SecurityAuditor,
    SecurityError,
)
from .validation import (
    ActionValidator,
    NumericalValidator,
    PhysicsValidator,
    ValidationError,
    validate_action,
    validate_environment_config,
    validate_magnetization,
    validate_observation,
    validate_parameters,
)

__all__ = [
    "measure_env_throughput",
    "measure_train_throughput",
    "load_env_state",
    "load_train_state",
    "save_env_state",
    "save_train_state",
    "AdaptiveCache",
    "CacheManager",
    "CacheStats",
    "LRUCache",
    "cached",
    "get_cache_manager",
    "AsyncEnvironmentManager",
    "ParallelBenchmark",
    "PhysicsWorkerPool",
    "ResourcePool",
    "parallel_map",
    "DeviceHealthCheck",
    "EnvironmentHealthCheck",
    "HealthCheck",
    "PhysicsHealthCheck",
    "SystemHealthCheck",
    "build_full_health_monitor",
    "get_health_monitor",
    "ComputationOptimizer",
    "get_optimizer",
    "pad_batch",
    "unpad_batch",
    "ScalableEnvironmentManager",
    "AdaptiveResourceManager",
    "AutoScaler",
    "LoadBalancer",
    "CheckpointManager",
    "load_params",
    "load_pytree",
    "save_params",
    "save_pytree",
    "ConfigurationError",
    "DeviceError",
    "ErrorRecoveryManager",
    "NumericalError",
    "PhysicsError",
    "SpinTorqueError",
    "robust_computation",
    "safe_division",
    "safe_execute",
    "safe_log",
    "safe_normalize",
    "safe_sqrt",
    "LoggingContext",
    "PerformanceLogger",
    "StructuredFormatter",
    "get_logger",
    "setup_logging",
    "EnvironmentMonitor",
    "HealthMonitor",
    "MetricsCollector",
    "SafetyWrapper",
    "default_health_monitor",
    "PerformanceProfiler",
    "block_and_time",
    "device_trace",
    "InputSanitizer",
    "RateLimiter",
    "SecureHasher",
    "SecurityAuditor",
    "SecurityError",
    "ActionValidator",
    "NumericalValidator",
    "PhysicsValidator",
    "ValidationError",
    "validate_action",
    "validate_environment_config",
    "validate_magnetization",
    "validate_observation",
    "validate_parameters",
]
