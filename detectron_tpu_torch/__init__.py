"""detectron_tpu_torch: the PyTorch / CUDA port of detectron_tpu.

Mirrors the JAX package's layout (``config/``, ``ops/``, ``layers/``,
``models/``, ``utils/``) and keeps its public layouts and contracts. The
two kernels of the inference path, greedy NMS and multilevel RoIAlign, are
hand-written CUDA C++ for Hopper under ``csrc/``, built at first use by
``_build``. Entry points run on the card unless given ``device="cpu"``.
"""
