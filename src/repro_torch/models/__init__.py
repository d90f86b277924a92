"""The model zoo: the dense, MoE (Mixtral's sliding window and rolling
cache included) and VLM transformers, the SeamlessM4T encoder-decoder,
RWKV-6 and the Jamba hybrid — prefill and decode from a KV cache or a
recurrent state — with the transformers' int8 KV cache, and every
model's training loss (`loss_fn`, `losses.py`), and the logical axis
sharding of every one of them over a `DeviceMesh` (`AxisRules`,
`rules_for`, `NULL_RULES`: `models/common.py`)."""

from .api import batch_desc, build_model, input_specs
from .common import (NULL_RULES, AxisRules, Desc, abstract_params,
                     distribute_params, init_params, param_count, rules_for,
                     stack_tree)
from .convert import params_from_numpy
from .encdec import EncDecModel
from .hybrid import HybridModel
from .rwkv_model import RWKVModel
from .transformer import TransformerModel

__all__ = ["batch_desc", "build_model", "input_specs", "AxisRules", "Desc",
           "NULL_RULES", "abstract_params", "distribute_params",
           "init_params", "param_count", "rules_for", "stack_tree",
           "params_from_numpy", "EncDecModel", "HybridModel", "RWKVModel",
           "TransformerModel"]
