"""ray_tpu_torch.rllib: RLlib on the card (port of ray_tpu/rllib).

Capability parity: reference rllib/ new API stack — Algorithm/AlgorithmConfig,
Learner/LearnerGroup, RLModule, EnvRunner(Group), ConnectorV2; PPO, DQN and SAC
with replay, and CQL, MARWIL and BC from offline data. Module names follow the
JAX package. The learner runs on the card unless the config asks for the CPU
(``.learners(device="cpu")``); the env runners, the replay buffers and the
offline rows stay on the host in numpy. gymnasium is optional: it is imported
only to ``gym.make`` a string env id or to wrap an env class without
``make_vec``.

The names below that the port has not ported yet raise NotImplementedError
naming their ROADMAP item when called.
"""
from .algorithms.algorithm import Algorithm  # noqa: F401
from .algorithms.algorithm_config import AlgorithmConfig  # noqa: F401
from .algorithms.cql import CQL, CQLConfig, CQLLearner  # noqa: F401
from .algorithms.dqn import DQN, DQNConfig, DQNLearner  # noqa: F401
from .algorithms.marwil import BC, BCConfig, MARWIL, MARWILConfig, MARWILLearner  # noqa: F401
from .algorithms.ppo import PPO, PPOConfig, PPOLearner  # noqa: F401
from .algorithms.sac import SAC, SACConfig, SACLearner  # noqa: F401
from .connectors import ConnectorPipelineV2, ConnectorV2, GeneralAdvantageEstimation  # noqa: F401
from .core.learner import Learner  # noqa: F401
from .core.learner_group import LearnerGroup  # noqa: F401
from .core.rl_module import Columns, MLPModule, RLModule, RLModuleSpec  # noqa: F401
from .env.env_runner import SingleAgentEnvRunner  # noqa: F401
from .env.env_runner_group import EnvRunnerGroup  # noqa: F401
from .env.episode import SingleAgentEpisode  # noqa: F401
from .offline import OfflineData, OfflinePreLearner  # noqa: F401
from .utils.metrics_logger import MetricsLogger  # noqa: F401


def _not_ported(name: str, item: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported to ray_tpu_torch yet (ROADMAP {item})")

    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet (ROADMAP {item}); raises when called."})


_NOT_PORTED = {
    "A9d": ("APPO", "APPOConfig", "APPOLearner", "IMPALA", "IMPALAConfig", "IMPALALearner"),
    "A9g": ("MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentEnv", "make_multi_agent",
            "MultiAgentEnvRunner", "MultiAgentEpisode", "MultiAgentLearner"),
    "A9h": ("DreamerV3", "DreamerV3Config", "DreamerV3Learner"),
}
for _item, _names in _NOT_PORTED.items():
    for _name in _names:
        globals()[_name] = _not_ported(_name, _item)
del _item, _names, _name
