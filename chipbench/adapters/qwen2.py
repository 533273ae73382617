"""Qwen2 dense models in the port: ``repro_torch.models.ModelConfig`` with
QKV biases and a tied output head, and the harness's weights
(``reference/qwen2.py``'s layout) as the port's tree.  Every leaf is the
harness's tensor itself, not a copy: the port's stacked layout and (in,
out) weights are the harness's."""
from repro_torch.models.config import ModelConfig


def port_config(c, dtype="bfloat16"):
    return ModelConfig(
        name=c["name"], arch_type="dense",
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        qkv_bias=True, tie_embeddings=True,
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        max_seq=c["context_length"], dtype=dtype)


def port_params(W):
    block = {"norm": {"scale": W["attn_norm"]},
             "attn": {"q": W["wq"], "k": W["wk"], "v": W["wv"], "o": W["wo"],
                      "q_b": W["bq"], "k_b": W["bk"], "v_b": W["bv"]},
             "mlp_norm": {"scale": W["mlp_norm"]},
             "mlp": {"gate": W["w_gate"], "up": W["w_up"],
                     "down": W["w_down"]}}
    return {"embed": {"embedding": W["embed"]},
            "final_norm": {"scale": W["final_norm"]},
            "stages": [{"blocks": (block,)}]}
