"""Share of the fenced profile's wall time with no operation on the device
(1 - busy / wall), over the profiled requests."""

LAYER = "device"
MOVES = "serve_img_per_s"
UNIT = "%"


def read(t):
    if not t.profile_s or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.profile_s)
