"""detectron_tpu_torch: the PyTorch / CUDA port of detectron_tpu.

Mirrors the JAX package's layout (``config/``, ``ops/``, ``layers/``,
``models/``, ``data/``, ``eval/``, ``train/``, ``native/``, ``parallel/``,
``utils/``) and
keeps its public layouts and contracts. The three kernels of the
inference and training paths, greedy NMS and the multilevel RoIAlign
forward and backward, are hand-written CUDA C++ for Hopper under
``csrc/``, built at first use by ``_build``; the RLE codec of the eval path
is C++ under ``native/``. Entry points (``eval.driver``, ``train.driver``,
``bench``) run on the card unless given ``device="cpu"``.
"""
