"""The port's deployment tier against the JAX package's.

Counterpart of tests/unit/test_deployment.py, test_compliance.py,
test_serving_endpoint.py and test_monitoring_stack.py, on the CPU
(``device="cpu"``): launch commands (torchrun's, one rank per card), the
audit log, the manager, serving health, the compliance framework, the
regional gate, readiness, and the HTTP endpoint over a real socket on
port 0. Parity: ``validate_region_config`` gives the JAX package's verdict
for every region (and an unknown one) x every subset of the standards x
residency on and off, and ``ComplianceFramework`` reports and erasures
equal JAX's apart from timestamps and ids. The compose monitoring
profile's dashboards query only metrics the port's ``HealthState``
exports.
"""

import itertools
import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

import spintorque_tpu.deployment as JD
from spintorque_tpu_torch.deployment import (
    ComplianceFramework,
    ComplianceLog,
    DeploymentManager,
    DeploymentSpec,
    GlobalDeploymentManager,
    RegionConfig,
    ServingEndpoint,
    compliance,
    production_readiness,
    serving_health,
    validate_region_config,
)
from spintorque_tpu_torch.deployment.server import HealthState

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MON = os.path.join(REPO, "deployment", "monitoring")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"  # a record's card line, as nvidia-smi gives it


# ---------------------------------------------------------------------------
# manager (tests/unit/test_deployment.py)


def test_deployment_spec_launch_commands_are_torchruns():
    spec = DeploymentSpec(name="prod", num_hosts=4, chips_per_host=4, batch_size=4096,
                          env_vars={"SPIN_TORQUE_SEED": "3"})
    cmds = spec.launch_commands("10.0.0.1")
    assert len(cmds) == 4
    for i, cmd in enumerate(cmds):
        assert "torchrun --nnodes 4 " in cmd and f"--node_rank {i} " in cmd
        assert "--nproc_per_node 4 " in cmd
        assert "--master_addr 10.0.0.1 --master_port 8476 " in cmd
        assert cmd.endswith("-m spintorque_tpu_torch.cli train")
        for var in ("SPIN_TORQUE_BATCH_SIZE=4096", "SPIN_TORQUE_MESH_MODEL=1",
                    "SPIN_TORQUE_SEED=3"):
            assert var in cmd
        assert "JAX_" not in cmd
    assert json.loads(spec.to_json()) == json.loads(JD.DeploymentSpec(
        name="prod", num_hosts=4, chips_per_host=4, batch_size=4096,
        env_vars={"SPIN_TORQUE_SEED": "3"}).to_json())


def test_compliance_log(tmp_path):
    log = ComplianceLog(path=tmp_path / "audit.jsonl")
    log.record("tester", "model_update", "v2")
    log.record("tester", "model_update", "v3")
    log.record("tester", "config_change", "lr")
    rep = log.report()
    assert rep["total"] == 3 and rep["by_action"]["model_update"] == 2
    lines = (tmp_path / "audit.jsonl").read_text().strip().splitlines()
    assert len(lines) == 3 and json.loads(lines[0])["action"] == "model_update"


def test_deployment_manager_validation():
    mgr = DeploymentManager()
    good = DeploymentSpec(name="ok", num_hosts=2, chips_per_host=4, batch_size=4096)
    bad = DeploymentSpec(name="bad", num_hosts=3, chips_per_host=4,
                         batch_size=4096)  # 4096 % 12 != 0
    mgr.register(good)
    rep = mgr.validate_environment(good)
    assert rep["ok"] and rep["local_devices"] == torch.cuda.device_count()
    assert rep["process_index"] == 0 and rep["process_count"] == 1
    assert not mgr.validate_environment(bad)["ok"]
    assert "ok" in mgr.status()["deployments"]


def test_serving_health():
    h = serving_health(device="cpu")
    assert h["status"] == "HEALTHY"
    assert h["backend"] == "cpu" and h["devices"] >= 1
    assert h["cuda_devices"] == torch.cuda.device_count()
    assert h["process_index"] == 0 and h["process_count"] == 1


def test_serving_health_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        assert serving_health()["backend"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving_health()


# ---------------------------------------------------------------------------
# compliance (tests/unit/test_compliance.py)


def test_processing_ledger_and_targeted_erasure():
    fw = ComplianceFramework(standards=("gdpr",))
    a = fw.record_processing("alice", ["trajectories"], "training")
    fw.record_processing("alice", ["metrics"], "monitoring")
    b = fw.record_processing("bob", ["trajectories"], "training")
    out = fw.request_erasure("alice", "gdpr")
    assert out["success"] and out["records_erased"] == 2
    assert fw.records[b].erased_at is None
    assert fw.records[a].erased_at is not None
    assert fw.request_erasure("alice", "gdpr")["records_erased"] == 0


def test_erasure_right_gated_by_standard():
    fw = ComplianceFramework(standards=("pdpa",))
    fw.record_processing("carol", ["trajectories"], "training")
    assert not fw.request_erasure("carol", "pdpa")["success"]


def test_retention_and_consent_policy_enforced():
    fw = ComplianceFramework(standards=("gdpr", "ccpa"))
    with pytest.raises(ValueError):
        fw.record_processing("d", ["x"], "p", retention_days=3000)
    with pytest.raises(ValueError):  # GDPR requires consent
        fw.record_processing("d", ["x"], "p", consent=False)
    fw2 = ComplianceFramework(standards=("ccpa",))
    fw2.record_processing("d", ["x"], "p", consent=False)
    rep = fw2.report()
    assert rep["records"] == 1 and rep["consent_rate"] == 0.0
    assert "improve consent collection" in rep["recommendations"]


def test_constants_equal_jax():
    assert compliance.REGIONS == JD.REGIONS
    assert compliance.STANDARDS == JD.STANDARDS
    assert compliance.STANDARD_POLICY == JD.STANDARD_POLICY
    assert compliance.REGION_RULES == JD.REGION_RULES


def _subsets(items):
    return [list(c) for r in range(len(items) + 1) for c in itertools.combinations(items, r)]


@pytest.mark.parametrize("region", list(JD.REGIONS) + ["nowhere-1"])
def test_region_verdicts_equal_jax(region):
    n = 0
    for standards, residency, encrypted in itertools.product(
            _subsets(JD.STANDARDS), (False, True), (False, True)):
        kw = dict(region=region, standards=standards, data_residency=residency,
                  encryption_in_transit=encrypted)
        assert validate_region_config(RegionConfig(**kw)) == JD.validate_region_config(
            JD.RegionConfig(**kw)), kw
        n += 1
    assert n == 16 * 2 * 2


def test_region_validation_rules():
    eu_bad = RegionConfig(region="europe-west4", standards=["ccpa"])
    v = validate_region_config(eu_bad)
    assert not v["valid"] and len(v["problems"]) == 2
    eu_ok = RegionConfig(region="europe-west4", standards=["gdpr"], data_residency=True)
    assert validate_region_config(eu_ok)["valid"]
    us = RegionConfig(region="us-central1", standards=[])
    v = validate_region_config(us)
    assert v["valid"] and v["warnings"]
    assert not validate_region_config(RegionConfig(region="nowhere-1"))["valid"]


def _ledger(mod, standards):
    fw = mod.ComplianceFramework(standards=standards)
    outcomes = []
    for subject, consent, days in (("alice", True, 30), ("bob", True, 400), ("alice", True, 900),
                                   ("carol", False, 10), ("dave", True, 5000)):
        try:
            fw.record_processing(subject, ["trajectories"], "training", consent=consent,
                                 retention_days=days)
            outcomes.append("recorded")
        except ValueError as e:
            outcomes.append(str(e))
    for s in ("gdpr", "ccpa", "pdpa", "pipeda", "unknown"):
        outcomes.append(fw.request_erasure("alice", s))
    outcomes.append(fw.sweep_expired())
    rep = fw.report()
    outcomes.append({k: v for k, v in rep.items()})
    outcomes.append(sorted(e["action"] for e in fw.events))
    return outcomes


@pytest.mark.parametrize("standards", [s for s in _subsets(JD.STANDARDS) if s],
                         ids=lambda s: "+".join(s))
def test_compliance_framework_reports_equal_jax(standards):
    assert _ledger(compliance, tuple(standards)) == _ledger(JD.compliance, tuple(standards))


def test_global_deployment_manager_failover_weights():
    mgr = GlobalDeploymentManager()
    us = RegionConfig(region="us-central1", standards=["ccpa"])
    eu = RegionConfig(region="europe-west4", standards=["gdpr"], data_residency=True)
    assert mgr.deploy(us)["success"]
    assert mgr.deploy(eu)["success"]
    assert mgr.deploy(us, dry_run=True)["dry_run"]
    assert mgr.load_balance_weights() == {"us-central1": 0.5, "europe-west4": 0.5}
    mgr.set_health("europe-west4", "degraded")
    w = mgr.load_balance_weights()
    assert w["europe-west4"] == 0.0 and w["us-central1"] == 1.0
    st = mgr.status()
    assert st["active"] == 2 and st["healthy"] == 1
    assert mgr.undeploy("europe-west4") and not mgr.undeploy("europe-west4")


def test_deploy_rejects_noncompliant_config():
    mgr = GlobalDeploymentManager()
    out = mgr.deploy(RegionConfig(region="europe-west4", standards=[]))
    assert not out["success"] and out["problems"]
    assert "europe-west4" not in mgr.regions


@pytest.fixture
def chip_record(tmp_path, monkeypatch):
    path = tmp_path / "chip_smoke.json"
    path.write_text(json.dumps({"card": CARD}))
    monkeypatch.setattr(compliance, "CHIP_SMOKE_RECORD", path)
    return path


def test_production_readiness_runs_real_checks(chip_record):
    rep = production_readiness(run_device_checks=False)
    assert set(rep["checks"]) >= {"package_import", "performance_evidence",
                                  "compliance_validation"}
    assert rep["checks"]["package_import"]["passed"]
    assert rep["checks"]["compliance_validation"]["passed"]
    assert 0.0 <= rep["score"] <= 100.0
    evidence = rep["checks"]["performance_evidence"]
    assert evidence == {"passed": True, "source": str(chip_record),
                        "card": CARD}
    assert rep["production_ready"]


def test_readiness_evidence_is_the_cards_record(tmp_path, monkeypatch):
    monkeypatch.setattr(compliance, "CHIP_SMOKE_RECORD", tmp_path / "missing.json")
    rep = production_readiness(run_device_checks=True, device="cpu")
    assert rep["checks"]["subsystem_health"]["passed"]
    assert set(rep["checks"]["subsystem_health"]["detail"]) == {"physics", "devices",
                                                                "environment", "system"}
    assert not rep["checks"]["performance_evidence"]["passed"]
    assert rep["blocking"] == ["performance_evidence"] and not rep["production_ready"]


# ---------------------------------------------------------------------------
# the serving endpoint (tests/unit/test_serving_endpoint.py)


@pytest.fixture(scope="module")
def endpoint(tmp_path_factory):
    record = tmp_path_factory.mktemp("record") / "chip_smoke.json"
    record.write_text(json.dumps({"card": CARD}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compliance, "CHIP_SMOKE_RECORD", record)
        # device checks on: on the CPU the health monitor's integrator and
        # env probes run for real and fast enough
        ep = ServingEndpoint(host="127.0.0.1", port=0, refresh_interval=3600.0, device="cpu")
        ep.start()
        yield ep
        ep.stop()


def _get(ep, path):
    url = f"http://127.0.0.1:{ep.port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_healthz(endpoint):
    code, body = _get(endpoint, "/healthz")
    data = json.loads(body)
    assert code == 200 and data["status"] == "HEALTHY"
    assert data["devices"] >= 1 and data["backend"] == "cpu"


def test_readiness(endpoint):
    code, body = _get(endpoint, "/readiness")
    data = json.loads(body)
    assert code == 200 and data["production_ready"]
    assert data["checks"]["subsystem_health"]["passed"]
    assert data["checks"]["performance_evidence"]["card"] == CARD


def test_metrics_exposition(endpoint):
    endpoint.state.record_metric("spintorque_env_steps_per_s", 12345.0)
    code, body = _get(endpoint, "/metrics")
    text = body.decode()
    assert code == 200
    assert "spintorque_health_ok 1" in text
    assert "spintorque_ready 1" in text
    assert "spintorque_env_steps_per_s 12345" in text
    assert "# TYPE spintorque_health_ok gauge" in text


def test_info_and_404(endpoint):
    code, body = _get(endpoint, "/info")
    data = json.loads(body)
    assert code == 200 and data["devices"] >= 1
    assert data["backend"] == "cpu" and data["process_index"] == 0
    assert data["process_count"] == 1
    code, _ = _get(endpoint, "/bogus")
    assert code == 404


def test_refresh_thread_refreshes_and_stops():
    state = HealthState(refresh_interval=0.05, run_device_checks=False, device="cpu")
    state.start()
    first = state.metric("spintorque_last_refresh_unixtime")
    deadline = time.monotonic() + 30
    while state.metric("spintorque_last_refresh_unixtime") == first:
        assert time.monotonic() < deadline, "the refresh thread did not refresh"
        time.sleep(0.02)
    state.stop()
    assert not state._thread.is_alive()


def test_cli_serve_wiring():
    """The serve subcommand parses and builds the endpoint (no listen)."""
    from spintorque_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["serve", "--port", "0", "--no-device-checks",
                                      "--device", "cpu"])
    assert args.func.__name__ == "cmd_serve"
    assert args.no_device_checks and args.device == "cpu"
    assert build_parser().parse_args(["serve"]).device == "cuda"


def test_endpoint_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEndpoint(host="127.0.0.1", port=0)


# ---------------------------------------------------------------------------
# the compose monitoring profile (tests/unit/test_monitoring_stack.py)


def test_dashboard_metrics_are_exported_by_the_port():
    """Every gauge the dashboard queries appears on the port's /metrics
    exposition, which parses as the prometheus text format."""
    state = HealthState(run_device_checks=False, device="cpu")
    state.refresh()
    state.record_metric("spintorque_env_steps_per_s", 1.0)
    text = state.metrics_text()
    exported = set(re.findall(r"^([a-zA-Z_:][a-zA-Z0-9_:]*) ", text, re.M))

    with open(os.path.join(MON, "grafana", "provisioning", "dashboards",
                           "spintorque.json")) as fh:
        dash = json.load(fh)
    queried = set()
    for panel in dash["panels"]:
        for target in panel.get("targets", []):
            queried |= set(re.findall(r"spintorque_[a-zA-Z0-9_]*", target["expr"]))
    assert queried, "dashboard queries no spintorque metrics"
    assert not queried - exported, f"dashboard queries unexported metrics: {queried - exported}"
    for line in text.strip().splitlines():
        assert re.match(
            r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* gauge$"
            r"|^[a-zA-Z_:][a-zA-Z0-9_:]* -?[0-9.e+-]+$",
            line,
        ), f"malformed exposition line: {line!r}"


def test_prometheus_scrapes_the_serve_port():
    with open(os.path.join(REPO, "docker-compose.yml")) as fh:
        serve = yaml.safe_load(fh)["services"]["serve"]
    port = serve["command"][serve["command"].index("--port") + 1]
    with open(os.path.join(MON, "prometheus.yml")) as fh:
        prom = yaml.safe_load(fh)
    targets = [t for sc in prom["scrape_configs"] for st in sc["static_configs"]
               for t in st["targets"]]
    assert f"serve:{port}" in targets
    # the port's serve subcommand takes the compose service's arguments
    from spintorque_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["serve", *map(str, serve["command"][
        serve["command"].index("serve") + 1:])])
    assert args.port == int(port)
