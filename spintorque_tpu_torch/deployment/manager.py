"""Deployment manifests, serving health, and audit logging.

PyTorch counterpart of ``spintorque_tpu/deployment/manager.py``. A
deployment is a set of hosts, each running one process per card under
``torchrun``, all in one process group (``parallel.initialize`` reads
torchrun's environment); this module generates their launch commands,
validates a host's readiness, exposes a serving health snapshot, and keeps
structured audit records.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class DeploymentSpec:
    """A multi-host deployment: ``num_hosts`` hosts of ``chips_per_host``
    cards, one rank per card."""

    name: str
    num_hosts: int = 1
    chips_per_host: int = 8
    coordinator_port: int = 8476
    batch_size: int = 4096
    mesh_model: int = 1
    env_vars: Dict[str, str] = field(default_factory=dict)
    regions: List[str] = field(default_factory=list)

    def launch_commands(self, coordinator_address: str) -> List[str]:
        """One command per host: ``torchrun`` starts one rank per card of
        the host, and the ranks of every host meet at
        ``coordinator_address:coordinator_port`` (torch's rendezvous)."""
        cmds = []
        for node in range(self.num_hosts):
            env = {
                "SPIN_TORQUE_BATCH_SIZE": str(self.batch_size),
                "SPIN_TORQUE_MESH_MODEL": str(self.mesh_model),
                **self.env_vars,
            }
            env_str = " ".join(f"{k}={v}" for k, v in sorted(env.items()))
            cmds.append(
                f"env {env_str} torchrun --nnodes {self.num_hosts} --node_rank {node} "
                f"--nproc_per_node {self.chips_per_host} --master_addr {coordinator_address} "
                f"--master_port {self.coordinator_port} -m spintorque_tpu_torch.cli train"
            )
        return cmds

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


@dataclass
class AuditRecord:
    timestamp: float
    actor: str
    action: str
    detail: str
    region: Optional[str] = None


class ComplianceLog:
    """Append-only structured audit log.

    Records deployment-relevant actions (model updates, config changes,
    data exports) with retention limits; exportable as JSONL for external
    compliance systems.
    """

    def __init__(self, path: Optional[str | Path] = None, retention: int = 10000):
        self.path = Path(path) if path else None
        self.retention = retention
        self.records: List[AuditRecord] = []

    def record(self, actor: str, action: str, detail: str = "",
               region: Optional[str] = None) -> AuditRecord:
        rec = AuditRecord(time.time(), actor, action, detail, region)
        self.records.append(rec)
        if len(self.records) > self.retention:
            self.records = self.records[-self.retention // 2 :]
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(asdict(rec)) + "\n")
        return rec

    def report(self) -> Dict[str, Any]:
        by_action: Dict[str, int] = {}
        for r in self.records:
            by_action[r.action] = by_action.get(r.action, 0) + 1
        return {"total": len(self.records), "by_action": by_action}


def serving_health(device=None) -> Dict[str, Any]:
    """Snapshot for a /healthz-style serving endpoint: the basic health
    checks on ``device`` (the card unless the caller asks for "cpu"), the
    backend and its device count (the CUDA cards, or the host as one
    device), and this process's rank and world size."""
    import torch

    from ..parallel import process_info
    from ..parallel.mesh import resolve_device
    from ..utils.monitoring import default_health_monitor

    dev = resolve_device(device, None)
    checks = default_health_monitor(dev).run()
    info = process_info()
    return {
        "status": checks["status"],
        "backend": dev.type,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "cuda_devices": torch.cuda.device_count(),
        "process_index": info["process_index"],
        "process_count": info["process_count"],
        "time": time.time(),
        "checks": checks["checks"],
    }


class DeploymentManager:
    """Tracks deployments and readiness."""

    def __init__(self, audit: Optional[ComplianceLog] = None):
        self.deployments: Dict[str, DeploymentSpec] = {}
        self.audit = audit or ComplianceLog()

    def register(self, spec: DeploymentSpec) -> None:
        self.deployments[spec.name] = spec
        self.audit.record("deployment-manager", "register", spec.name)

    def validate_environment(self, spec: DeploymentSpec) -> Dict[str, Any]:
        """Host-side readiness checks before launching a deployment."""
        import torch

        from ..parallel import process_info

        problems = []
        if spec.num_hosts < 1:
            problems.append("num_hosts must be >= 1")
        if spec.batch_size % max(1, spec.num_hosts * spec.chips_per_host):
            problems.append("batch_size not divisible by total chips")
        info = process_info()
        report = {
            "ok": not problems,
            "problems": problems,
            "local_devices": torch.cuda.device_count(),
            "backend": "cuda" if torch.cuda.is_available() else "cpu",
            "process_index": info["process_index"],
            "process_count": info["process_count"],
        }
        self.audit.record("deployment-manager", "validate", json.dumps(report))
        return report

    def status(self) -> Dict[str, Any]:
        return {
            "deployments": {n: asdict(s) for n, s in self.deployments.items()},
            "audit": self.audit.report(),
        }
