from .attention import (attention_blockwise, attention_reference,
                        flash_attention, flash_attention_blhd,
                        flash_backward_blhd, flash_backward_reference,
                        flash_forward_blhd, flash_forward_reference)
from .fused_dropout_ln import (dln_backward, dln_backward_reference,
                               dln_forward, dln_forward_reference,
                               dropout_add_layer_norm)
from .kv_cache import (DecodeState, cache_length_buckets,
                       cached_attention_step, decode_step_is_cached,
                       evict_slot, init_decode_state, pick_cache_bucket,
                       place_slot, write_prompt)
from .layernorm import layer_norm

__all__ = ["attention_blockwise", "attention_reference", "flash_attention",
           "flash_attention_blhd", "flash_backward_blhd",
           "flash_backward_reference", "flash_forward_blhd",
           "flash_forward_reference", "dln_backward",
           "dln_backward_reference", "dln_forward", "dln_forward_reference",
           "dropout_add_layer_norm", "layer_norm", "DecodeState",
           "cache_length_buckets", "cached_attention_step",
           "decode_step_is_cached", "evict_slot", "init_decode_state",
           "pick_cache_bucket", "place_slot", "write_prompt"]
