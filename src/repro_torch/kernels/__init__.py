# Hand-written CUDA kernels for Hopper (csrc/*.cu, built by build.py) with
# their Python wrappers, plain PyTorch versions, and a device-dispatching
# layer (ops.py).  Ported so far: GAE, the PPO surrogate (fwd + bwd), decode
# attention and flash attention (fwd + bwd).
