"""The model zoo: the dense, MoE (Mixtral's sliding window and rolling
cache included) and VLM transformers, the SeamlessM4T encoder-decoder,
RWKV-6 and the Jamba hybrid — prefill and decode from a KV cache or a
recurrent state — with the transformers' int8 KV cache, and every
model's training loss (`loss_fn`, `losses.py`). Not ported yet:
sharding (ROADMAP queue 1, item 7)."""

from .api import batch_desc, build_model
from .common import Desc, init_params, param_count, stack_tree
from .convert import params_from_numpy
from .encdec import EncDecModel
from .hybrid import HybridModel
from .rwkv_model import RWKVModel
from .transformer import TransformerModel

__all__ = ["batch_desc", "build_model", "Desc", "init_params", "param_count",
           "stack_tree", "params_from_numpy", "EncDecModel", "HybridModel",
           "RWKVModel", "TransformerModel"]
