"""Mean ms of trainer.collect (the rollout: 16 env steps with the policy)
over the window's train steps, by CUDA events around the call."""


def read(records):
    ms = records.get("rollout_ms")
    return sum(ms) / len(ms) if ms else None
