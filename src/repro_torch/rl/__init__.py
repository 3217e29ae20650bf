from repro_torch.rl.advantages import discounted_returns, gae, vtrace
from repro_torch.rl.env import (
    CartPole,
    CartPoleState,
    Env,
    MultiAgentCartPole,
    Pendulum,
    StubEnv,
    VectorEnv,
    VectorEnvState,
    VectorStep,
)
from repro_torch.rl.inference import (
    AdmissionQueue,
    CreditGate,
    InferenceActor,
    InferenceClient,
    InferenceRouter,
    InferenceUnavailable,
)
from repro_torch.rl.learner_group import ShardedLearnerGroup
from repro_torch.rl.lm_policy import LMTokenPolicy
from repro_torch.rl.model_based import ModelBasedWorker
from repro_torch.rl.policy import (
    ActorCriticPolicy,
    DQNPolicy,
    DummyPolicy,
    SACPolicy,
    mlp_apply,
    mlp_init,
)
from repro_torch.rl.replay import ReplayBuffer
from repro_torch.rl.rollout_worker import (
    EPS_STRIDE,
    MAX_LANES,
    MultiAgentRolloutWorker,
    PerEnvRolloutWorker,
    RolloutWorker,
    VectorizedRolloutWorker,
    assemble_fragments,
)
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch, concat_batches
from repro_torch.rl.stateful_policy import SSMStatePolicy
from repro_torch.rl.token_env import (
    EOS,
    PAD,
    TokenEnv,
    TokenEnvState,
    make_obs,
    split_obs,
    target_token_reward,
)
from repro_torch.rl.transformer_policy import TransformerPolicy

__all__ = [k for k in dir() if not k.startswith("_")]
