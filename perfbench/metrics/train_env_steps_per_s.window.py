"""Train env-steps/s: rollout steps x envs of every train step completed in
the window over the window's seconds (host clock), each step ended by a
synchronize. The launch-bound train step sets it by the host's speed, so
it is read per layer, beside the end-to-end ``train_step_busy_ms``."""


def read(records):
    w = records["window"]
    return w["env_steps"] / w["seconds"]
