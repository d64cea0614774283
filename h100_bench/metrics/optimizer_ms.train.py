"""Device time of the optimizer (clip, AdamW, the non-finite skip): CUDA
events around ``TrainState.apply_gradients`` of the stepped state, mean
over the traced window's steps."""

LAYER = "optimizer (train/state.py::TrainState.apply_gradients)"
MOVES = "train_img_per_s"
UNIT = "ms"


def read(t):
    ms = t.spans.get("optimizer")
    return sum(ms) / len(ms) if ms else None
