from .attention import (attention_blockwise, attention_reference,
                        flash_attention, flash_attention_blhd,
                        flash_backward_blhd, flash_backward_reference,
                        flash_forward_blhd, flash_forward_reference)
from .fused_dropout_ln import (dln_backward, dln_backward_reference,
                               dln_forward, dln_forward_reference,
                               dropout_add_layer_norm)
from .layernorm import layer_norm

__all__ = ["attention_blockwise", "attention_reference", "flash_attention",
           "flash_attention_blhd", "flash_backward_blhd",
           "flash_backward_reference", "flash_forward_blhd",
           "flash_forward_reference", "dln_backward",
           "dln_backward_reference", "dln_forward", "dln_forward_reference",
           "dropout_add_layer_norm", "layer_norm"]
