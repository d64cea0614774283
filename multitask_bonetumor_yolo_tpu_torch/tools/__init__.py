"""Entry points of the port outside the library, each run as
``python -m multitask_bonetumor_yolo_tpu_torch.tools.<name>``: the
counterparts of the JAX repo's scripts (``kernel_lab``, ``bench_block``,
``profile_infer``, ``profile_train``, ``train_synthetic``, ``diagnose_det``),
and the card's own diagnostics of its kernels (``k1_knockout``,
``k3_variants``)."""
