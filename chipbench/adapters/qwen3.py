"""Qwen3 dense models in the port: ``repro_torch.models.ModelConfig`` with
QK norms, and the harness's weights (``reference/qwen3.py``'s layout) as
the port's tree.  Every leaf is the harness's tensor itself, not a copy:
the port's stacked layout and (in, out) weights are the harness's."""
from repro_torch.models.config import ModelConfig


def port_config(c, dtype="bfloat16"):
    return ModelConfig(
        name=c["name"], arch_type="dense",
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        qk_norm=True, rope_theta=float(c["rope_theta"]),
        norm_eps=c["rms_norm_eps"], max_seq=c["context_length"], dtype=dtype)


def port_params(W):
    block = {"norm": {"scale": W["attn_norm"]},
             "attn": {"q": W["wq"], "k": W["wk"], "v": W["wv"], "o": W["wo"],
                      "q_norm": W["q_norm"], "k_norm": W["k_norm"]},
             "mlp_norm": {"scale": W["mlp_norm"]},
             "mlp": {"gate": W["w_gate"], "up": W["w_up"],
                     "down": W["w_down"]}}
    return {"embed": {"embedding": W["embed"], "lm_head": W["lm_head"]},
            "final_norm": {"scale": W["final_norm"]},
            "stages": [{"blocks": (block,)}]}
