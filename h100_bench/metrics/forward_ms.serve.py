"""Device time of the model's forward in a serving request: CUDA events at
the forward pre-hook and the forward hook of ``MultitaskModel`` (``mode=
"infer"``), mean over the traced window's requests."""

LAYER = "model forward (models/model.py::MultitaskModel)"
MOVES = "serve_img_per_s"
UNIT = "ms"


def read(t):
    ms = t.spans.get("forward")
    return sum(ms) / len(ms) if ms else None
