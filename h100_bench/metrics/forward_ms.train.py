"""Device time of the model's forward in a train step (``mode="train"``):
CUDA events at the forward pre-hook and the forward hook of
``MultitaskModel``, mean over the traced window's steps."""

LAYER = "model forward (models/model.py::MultitaskModel)"
MOVES = "train_img_per_s"
UNIT = "ms"


def read(t):
    ms = t.spans.get("forward")
    return sum(ms) / len(ms) if ms else None
