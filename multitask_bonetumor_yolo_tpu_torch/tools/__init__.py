"""Diagnostic entry points of the port (not part of the library): the kernel
lab (``python -m multitask_bonetumor_yolo_tpu_torch.tools.kernel_lab``) and
K1's Hopper design with parts cut out (``...tools.k1_knockout``)."""
