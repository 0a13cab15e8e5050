# tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
# vocab=32000; llama2-arch small. [arXiv:2401.02385; hf]
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000, kv_shards=16, grad_accum=2,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=256, param_dtype="float32",
                      kv_shards=1, attn_chunk=32)
