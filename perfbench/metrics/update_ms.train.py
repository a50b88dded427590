"""Mean ms of trainer.update (GAE and 4 x 4 minibatch steps: forward,
backward, clip, Adam) over the window's train steps, by CUDA events
around the call."""


def read(records):
    ms = records.get("update_ms")
    return sum(ms) / len(ms) if ms else None
