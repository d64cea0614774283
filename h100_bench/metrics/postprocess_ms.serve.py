"""Device time from the end of the model's forward to the return of
``infer_batch`` (decode, NMS and the instance masks, with NMS's waits on
the host inside it): CUDA events, mean over the traced window's
requests."""

LAYER = "decode, NMS and masks (ops/nms.py, ops/masks.py)"
MOVES = "serve_p95_ms"
UNIT = "ms"


def read(t):
    ms = t.spans.get("post")
    return sum(ms) / len(ms) if ms else None
