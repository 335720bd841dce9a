"""The Mistral family: Mistral-7B (dense) and Mixtral-8x7B (experts).

One kind of layer throughout: pre-norm, full causal grouped-query
attention with rotary embeddings at one `rope_theta`, then a SwiGLU FFN
of `intermediate_size`, or a top-k mixture of SwiGLU experts of that
width (`num_local_experts`, `num_experts_per_tok`,
`router_aux_loss_coef`). A config file that names no architecture is of
this one.

An architecture module gives what the harness needs that the
architecture shapes: `dims` (the sizes, read from the published keys),
`leaf_specs` (the weight layout), `program_config` (the port's config
object) and `reference` (the module under `reference/` that computes it
plainly).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, Tuple

from gpubench.weights import QK_GAIN

reference = "decoder"


def dims(config: dict) -> SimpleNamespace:
    """The sizes of a config file under the port's names, read without
    the program. Per layer: its attention window (0: full) and its FFN's
    kind (`dense` or `experts`)."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    layers = config["num_hidden_layers"]
    experts = int(config.get("num_local_experts") or 0)
    return SimpleNamespace(
        vocab_size=config["vocab_size"], d_model=d, n_layers=layers,
        n_heads=heads, kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or d // heads,
        d_ff=config["intermediate_size"],
        d_ff_expert=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        moe_num_experts=experts,
        moe_top_k=int(config.get("num_experts_per_tok") or 0),
        tie_embeddings=bool(config["tie_word_embeddings"]),
        windows=(0,) * layers,
        ffn_kinds=("experts" if experts else "dense",) * layers)


def leaf_specs(dims) -> List[Tuple[str, tuple, float]]:
    """(name, shape of one layer's leaf, std) of every per-layer leaf."""
    e, hd = dims.d_model, dims.head_dim
    qd, kvd = dims.n_heads * hd, dims.kv_heads * hd
    specs = [("attn_norm", (e,), 0.1),
             ("wq", (e, qd), QK_GAIN / math.sqrt(e)),
             ("wk", (e, kvd), QK_GAIN / math.sqrt(e)),
             ("wv", (e, kvd), 1 / math.sqrt(e)),
             ("wo", (qd, e), 1 / math.sqrt(qd)),
             ("mlp_norm", (e,), 0.1)]
    E = dims.moe_num_experts
    if E:
        f = dims.d_ff_expert
        specs += [("router", (e, E), 1 / math.sqrt(e)),
                  ("moe_gate", (E, e, f), 1 / math.sqrt(e)),
                  ("moe_up", (E, e, f), 1 / math.sqrt(e)),
                  ("moe_down", (E, f, e), 1 / math.sqrt(f))]
    else:
        f = dims.d_ff
        specs += [("gate", (e, f), 1 / math.sqrt(e)),
                  ("up", (e, f), 1 / math.sqrt(e)),
                  ("down", (f, e), 1 / math.sqrt(f))]
    return specs


def program_config(config: dict):
    """The port's TransformerConfig: the published keys mapped to the
    port's names, then the settings under `run`."""
    from ray_tpu_torch.models.config import TransformerConfig
    kw = dict(
        vocab_size=config["vocab_size"], d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]))
    if config.get("num_local_experts"):
        kw.update(moe_num_experts=config["num_local_experts"],
                  moe_top_k=config["num_experts_per_tok"],
                  moe_aux_coef=float(config["router_aux_loss_coef"]))
    kw.update(config.get("run", {}))
    return TransformerConfig(**kw)
