from repro_torch.rl.advantages import gae
from repro_torch.rl.env import CartPole, CartPoleState, Env, VectorEnv, VectorEnvState, VectorStep
from repro_torch.rl.lm_policy import LMTokenPolicy
from repro_torch.rl.policy import ActorCriticPolicy, mlp_apply, mlp_init
from repro_torch.rl.rollout_worker import (
    EPS_STRIDE,
    MAX_LANES,
    RolloutWorker,
    VectorizedRolloutWorker,
    assemble_fragments,
)
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch, concat_batches
from repro_torch.rl.token_env import (
    EOS,
    PAD,
    TokenEnv,
    TokenEnvState,
    make_obs,
    split_obs,
    target_token_reward,
)

__all__ = [k for k in dir() if not k.startswith("_")]
