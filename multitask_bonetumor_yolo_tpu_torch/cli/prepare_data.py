"""CLI: convert raw BTXRD (labelme + metadata) into a training-ready dir
(counterpart of the JAX ``cli/prepare_data.py``; the converter is
``data/convert.py``):

    python -m multitask_bonetumor_yolo_tpu_torch.cli.prepare_data \
        --src BTXRD --meta dataset.csv --dst btxrd_ready
"""

from ..data.convert import main

if __name__ == "__main__":
    main()
