"""The benchmark's plain reference: the model, its loss, the train step and
the decode stages in plain fp32 PyTorch, written from the upstream model's
description. It imports nothing of the program under test."""
