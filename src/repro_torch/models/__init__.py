"""The model zoo, ported so far for the dense and MoE transformers
(prefill and KV-cache decode), RWKV-6 (prefill and recurrent-state
decode) and the Jamba hybrid (prefill, then decode from the Mamba states
and the KV cache)."""

from .api import build_model
from .common import Desc, init_params, param_count, stack_tree
from .convert import params_from_numpy
from .hybrid import HybridModel
from .rwkv_model import RWKVModel
from .transformer import TransformerModel

__all__ = ["build_model", "Desc", "init_params", "param_count", "stack_tree",
           "params_from_numpy", "HybridModel", "RWKVModel",
           "TransformerModel"]
