"""The paper's own evaluation models (BERT / ViT) — used by the accesys
workload traces (Figs 7-13, Tables 8-9) and runnable as encoder configs.
"""
from repro_torch.configs.base import ModelConfig


def _encoder(name: str, n_layers: int, d_model: int, n_heads: int,
             seq: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=4 * d_model,
        vocab_size=30522, norm="layernorm", act="gelu", glu=False,
        rope="none", max_train_seq=seq,
    )


# BERT family (seq 128 in the paper); ViT family (224^2 -> 196(+1) patches)
BERT_MEDIUM = _encoder("bert-medium", 8, 512, 8, 128)
BERT_BASE = _encoder("bert-base", 12, 768, 12, 128)
BERT_LARGE = _encoder("bert-large", 24, 1024, 16, 128)
VIT_BASE = _encoder("vit-base-16", 12, 768, 12, 197)
VIT_LARGE = _encoder("vit-large-16", 24, 1024, 16, 197)
VIT_HUGE = _encoder("vit-huge-14", 32, 1280, 16, 257)

PAPER_MODELS = {
    m.name: m for m in
    [BERT_MEDIUM, BERT_BASE, BERT_LARGE, VIT_BASE, VIT_LARGE, VIT_HUGE]
}
