"""Host time of a Session.step call, mean over the measured window: the
benchmark's own span around each call (session layer)."""


def read(r):
    if not r.host_step_ms:
        return None
    return sum(r.host_step_ms) / len(r.host_step_ms)
