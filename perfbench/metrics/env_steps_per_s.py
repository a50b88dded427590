"""env-steps/s: every env-step completed in the window over the window's
seconds, the window ending at a synchronize."""


def read(records):
    w = records["window"]
    return w["env_steps"] / w["seconds"]
