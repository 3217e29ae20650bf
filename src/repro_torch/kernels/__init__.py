# Hand-written CUDA kernels for Hopper (csrc/*.cu, built by build.py) with
# their Python wrappers, plain PyTorch versions, and a device-dispatching
# layer (ops.py): GAE, V-trace, the PPO surrogate (fwd + bwd), decode
# attention, flash attention (fwd + bwd), the RWKV-6 recurrence (fwd + bwd)
# and the MoE grouped matmul.
