"""The model zoo, ported so far for the dense transformer (prefill and
KV-cache decode) and RWKV-6 (prefill and recurrent-state decode)."""

from .api import build_model
from .common import Desc, init_params, param_count, stack_tree
from .convert import params_from_numpy
from .rwkv_model import RWKVModel
from .transformer import TransformerModel

__all__ = ["build_model", "Desc", "init_params", "param_count", "stack_tree",
           "params_from_numpy", "RWKVModel", "TransformerModel"]
