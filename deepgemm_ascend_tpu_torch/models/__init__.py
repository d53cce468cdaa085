from .attention import AttentionParams, KVCache, attention
from .config import (LLAMA_LIKE, TINY, TINY_DENSE, V2_LITE, V2_LITE_FULL,
                     V3_STYLE, ModelConfig)
from .convert import params_from_numpy
from .layers import (BF16Linear, Fp8Linear, Int8Linear, apply_rope, rms_norm,
                     rope_freqs)
from .loader import (load_params, load_quantized, load_safetensors,
                     save_quantized)
from .model import (DenseFFN, LayerParams, ModelParams, decode_step, forward,
                    generate_greedy_scan, init_cache, init_params,
                    params_with_int8_experts)
from .moe import (ExpertWeights, Int8ExpertWeights, MoEParams,
                  dispatch_masked, int8_experts_from_fp8, moe_block,
                  route_topk)

__all__ = [
    "AttentionParams", "KVCache", "attention",
    "LLAMA_LIKE", "TINY", "TINY_DENSE", "V2_LITE", "V2_LITE_FULL",
    "V3_STYLE", "ModelConfig", "params_from_numpy",
    "BF16Linear", "Fp8Linear", "Int8Linear", "apply_rope", "rms_norm",
    "rope_freqs",
    "DenseFFN", "LayerParams", "ModelParams", "decode_step", "forward",
    "generate_greedy_scan", "init_cache", "init_params",
    "params_with_int8_experts",
    "load_params", "load_quantized", "load_safetensors", "save_quantized",
    "ExpertWeights", "Int8ExpertWeights", "MoEParams", "dispatch_masked",
    "int8_experts_from_fp8", "moe_block", "route_topk",
]
