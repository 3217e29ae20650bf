"""repro_torch: the PyTorch/CUDA port of ``repro`` (RLlib Flow).

It mirrors ``src/repro`` module for module and imports neither JAX nor
``repro``.  This slice carries the paper's Fig 10b PPO pipeline: the
actor/dataflow runtime (``core``), the FlowSpec IR with ``build_ppo`` and
``Algorithm`` (``flow``), the PPO numerics (``rl``, ``optim``) and the
hand-written CUDA kernels on its path (``kernels``: GAE and the PPO
surrogate, forward and backward).
"""
