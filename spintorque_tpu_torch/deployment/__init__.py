"""Deployment tooling: multi-host launch, serving health, audit records.

PyTorch counterpart of ``spintorque_tpu/deployment``, with the same names:
torchrun launch commands for multi-host deployments (one rank per card),
the HTTP serving endpoint with its health, readiness and metrics, and
compliance and audit record keeping.
"""

from .compliance import (
    REGION_RULES,
    REGIONS,
    STANDARD_POLICY,
    STANDARDS,
    ComplianceFramework,
    GlobalDeploymentManager,
    ProcessingRecord,
    RegionConfig,
    production_readiness,
    validate_region_config,
)
from .manager import (
    AuditRecord,
    ComplianceLog,
    DeploymentManager,
    DeploymentSpec,
    serving_health,
)
from .server import HealthState, ServingEndpoint

__all__ = [
    "AuditRecord",
    "ComplianceLog",
    "ComplianceFramework",
    "DeploymentManager",
    "DeploymentSpec",
    "GlobalDeploymentManager",
    "ProcessingRecord",
    "RegionConfig",
    "REGIONS",
    "REGION_RULES",
    "STANDARDS",
    "STANDARD_POLICY",
    "production_readiness",
    "serving_health",
    "validate_region_config",
    "HealthState",
    "ServingEndpoint",
]
