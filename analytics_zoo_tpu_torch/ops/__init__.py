from .attention import (attention_blockwise, attention_reference,
                        flash_attention, flash_attention_blhd,
                        flash_forward_blhd, flash_forward_reference)
from .fused_dropout_ln import dropout_add_layer_norm
from .layernorm import layer_norm

__all__ = ["attention_blockwise", "attention_reference", "flash_attention",
           "flash_attention_blhd", "flash_forward_blhd",
           "flash_forward_reference", "dropout_add_layer_norm",
           "layer_norm"]
