from repro_torch.rl.advantages import gae
from repro_torch.rl.env import CartPole, CartPoleState, Env
from repro_torch.rl.policy import ActorCriticPolicy, mlp_apply, mlp_init
from repro_torch.rl.rollout_worker import RolloutWorker
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch, concat_batches

__all__ = [k for k in dir() if not k.startswith("_")]
