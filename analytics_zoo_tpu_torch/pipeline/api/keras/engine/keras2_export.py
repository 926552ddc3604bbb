"""Emit a Keras-2 (tf.keras) python definition of a Sequential model.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/
keras2_export.py`` (parity: ``saveToKeras2``, ``Topology.scala:557``):
the same source text for the same stack, with this package's name where
the JAX module writes its own. Sequential stacks over the common layer
set; :func:`keras2_weights` returns the weights in tf.keras
``set_weights`` order (kernel before bias, Conv HWIO, LSTM/GRU W/U/b),
as numpy arrays.
"""

from __future__ import annotations

from typing import List


class Keras2ExportError(Exception):
    pass


class _Raw(str):
    """Identifier emitted verbatim (not repr-quoted) into the source."""

    def __repr__(self):
        return str(self)


def _maybe_k1_act(name):
    """Modern keras redefined hard_sigmoid as relu6(x+3)/6; the zoo keeps
    the Keras-1 clip(0.2x+0.5, 0, 1). Route to the parity helper emitted
    in the generated file's preamble."""
    if name == "hard_sigmoid":
        return _Raw("hard_sigmoid_k1")
    return name


def _args(**kw) -> str:
    parts = []
    for k, v in kw.items():
        if v is None:
            continue
        parts.append(f"{k}={v!r}")
    return ", ".join(parts)


def _data_format(layer) -> str:
    return ("channels_first"
            if getattr(layer, "dim_ordering", "tf") == "th"
            else "channels_last")


def _emit_layer(layer, is_first: bool) -> str:
    from .. import layers as zl

    kind = type(layer).__name__
    input_shape = None
    if is_first and layer.input_shape is not None:
        input_shape = tuple(layer.input_shape[1:])

    if getattr(layer, "go_backwards", False) and \
            getattr(layer, "return_sequences", False):
        # the zoo re-flips backward outputs to original time order
        # (recurrent.py _scan); tf.keras returns them reversed — the
        # combination is not representable without an extra reverse layer
        raise Keras2ExportError(
            f"layer {layer.name!r}: go_backwards with return_sequences "
            "has different output ordering in tf.keras")

    if isinstance(layer, zl.Dense):
        return (f"keras.layers.Dense({layer.output_dim}, "
                f"{_args(activation=_maybe_k1_act(_act_name(layer)), use_bias=layer.use_bias, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Convolution2D):
        dil = tuple(getattr(layer, "dilation", (1, 1)))
        if dil != (1, 1) and tuple(layer.subsample) != (1, 1):
            raise Keras2ExportError(
                f"layer {layer.name!r}: tf.keras Conv2D rejects strides > 1 "
                "combined with dilation_rate > 1")
        return (f"keras.layers.Conv2D({layer.nb_filter}, "
                f"{layer.kernel_size}, "
                f"{_args(strides=tuple(layer.subsample), padding=layer.border_mode, dilation_rate=dil if dil != (1, 1) else None, activation=_maybe_k1_act(_act_name(layer)), use_bias=layer.use_bias, data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Convolution1D):
        dil = int(getattr(layer, "dilation", 1))
        if dil != 1 and int(layer.subsample) != 1:
            raise Keras2ExportError(
                f"layer {layer.name!r}: tf.keras Conv1D rejects strides > 1 "
                "combined with dilation_rate > 1")
        return (f"keras.layers.Conv1D({layer.nb_filter}, "
                f"{layer.filter_length}, "
                f"{_args(strides=layer.subsample, padding=layer.border_mode, dilation_rate=dil if dil != 1 else None, activation=_maybe_k1_act(_act_name(layer)), use_bias=layer.use_bias, input_shape=input_shape, name=layer.name)})")
    # Average* subclasses of the Max* classes: check the subclass first
    if isinstance(layer, zl.AveragePooling2D):
        return (f"keras.layers.AveragePooling2D({tuple(layer.pool_size)}, "
                f"{_args(strides=tuple(layer.strides) if layer.strides else None, padding=layer.border_mode, data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.MaxPooling2D):
        return (f"keras.layers.MaxPooling2D({tuple(layer.pool_size)}, "
                f"{_args(strides=tuple(layer.strides) if layer.strides else None, padding=layer.border_mode, data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.GlobalAveragePooling2D):
        return (f"keras.layers.GlobalAveragePooling2D("
                f"{_args(data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.GlobalMaxPooling2D):
        return (f"keras.layers.GlobalMaxPooling2D("
                f"{_args(data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.GlobalAveragePooling1D):
        return (f"keras.layers.GlobalAveragePooling1D("
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.GlobalMaxPooling1D):
        return (f"keras.layers.GlobalMaxPooling1D("
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.AveragePooling1D):
        return (f"keras.layers.AveragePooling1D({layer.pool_length}, "
                f"{_args(strides=layer.stride, padding=layer.border_mode, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.MaxPooling1D):
        return (f"keras.layers.MaxPooling1D({layer.pool_length}, "
                f"{_args(strides=layer.stride, padding=layer.border_mode, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.BatchNormalization):
        return (f"keras.layers.BatchNormalization("
                f"{_args(axis=layer.axis, momentum=layer.momentum, epsilon=layer.epsilon, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.ZeroPadding2D):
        return (f"keras.layers.ZeroPadding2D({tuple(tuple(p) for p in layer.padding)}, "
                f"{_args(data_format=_data_format(layer), input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Reshape):
        return (f"keras.layers.Reshape({tuple(layer.target_shape)}, "
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.RepeatVector):
        return (f"keras.layers.RepeatVector({layer.n}, "
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.SimpleRNN):
        return (f"keras.layers.SimpleRNN({layer.output_dim}, "
                f"{_args(activation=_maybe_k1_act(_fn_name(layer.activation) or 'linear'), return_sequences=layer.return_sequences, go_backwards=layer.go_backwards or None, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Flatten):
        return (f"keras.layers.Flatten("
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Dropout):
        return (f"keras.layers.Dropout({layer.p}, "
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Activation):
        return (f"keras.layers.Activation({_maybe_k1_act(_act_name(layer))!r}, "
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.Embedding):
        return (f"keras.layers.Embedding({layer.input_dim}, "
                f"{layer.output_dim}, "
                f"{_args(input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.LSTM):
        return (f"keras.layers.LSTM({layer.output_dim}, "
                f"{_args(activation=_maybe_k1_act(_fn_name(layer.activation) or 'linear'), recurrent_activation=_maybe_k1_act(_fn_name(layer.inner_activation) or 'linear'), return_sequences=layer.return_sequences, go_backwards=layer.go_backwards or None, input_shape=input_shape, name=layer.name)})")
    if isinstance(layer, zl.GRU):
        return (f"keras.layers.GRU({layer.output_dim}, "
                f"{_args(activation=_maybe_k1_act(_fn_name(layer.activation) or 'linear'), recurrent_activation=_maybe_k1_act(_fn_name(layer.inner_activation) or 'linear'), return_sequences=layer.return_sequences, go_backwards=layer.go_backwards or None, reset_after=False, input_shape=input_shape, name=layer.name)})")
    raise Keras2ExportError(
        f"layer {layer.name!r} ({kind}) has no Keras-2 emission rule")


def _fn_name(fn):
    """Name of an activation function object. NamedActivation stores the
    registry string; raw functions fall back to ``__name__``. Emitting
    ``None`` for an unknown callable would silently linearize the layer,
    so unknown callables raise instead."""
    if fn is None:
        return None
    name = getattr(fn, "name", None) or getattr(fn, "__name__", None)
    if name is None:
        raise Keras2ExportError(
            f"activation {fn!r} has no resolvable name for Keras-2 export")
    return None if name == "linear" else name


def _act_name(layer):
    # Dense/Conv store the fn under .activation; the Activation layer
    # under .fn
    return _fn_name(getattr(layer, "activation", None) or
                    getattr(layer, "fn", None))


# tf.keras set_weights order per emitted layer type; "state:" prefixed
# names read from the layer's non-trainable state tree (BN moving stats)
_WEIGHT_ORDER = {
    "Dense": ("kernel", "bias"),
    "Convolution2D": ("kernel", "bias"),
    "Convolution1D": ("kernel", "bias"),
    "Embedding": ("table",),
    "LSTM": ("W", "U", "b"),
    "GRU": ("W", "U", "b"),
    "SimpleRNN": ("W", "U", "b"),
    "BatchNormalization": ("gamma", "beta", "state:moving_mean",
                           "state:moving_var"),
}


def keras2_weights(model):
    """Weights in the order ``build_model().set_weights`` expects (the
    zoo's ``get_weights`` flattens param dicts alphabetically, which puts
    bias before kernel)."""
    out = []
    for layer in model.layers:
        p = layer.param_tree()
        s = layer.state_tree()
        # walk the MRO so subclasses (AtrousConvolution2D -> Convolution2D)
        # inherit their base's weight order
        order = ()
        for klass in type(layer).__mro__:
            if klass.__name__ in _WEIGHT_ORDER:
                order = _WEIGHT_ORDER[klass.__name__]
                break
        for name in order:
            tree = p
            if name.startswith("state:"):
                name, tree = name[len("state:"):], s
            if name in tree:
                out.append(tree[name].detach().cpu().numpy())
    return out


def sequential_to_keras2_source(model) -> str:
    """Generate a runnable Keras-2 python definition for a Sequential."""
    from .topology import Sequential

    if not isinstance(model, Sequential):
        raise Keras2ExportError(
            "saveToKeras2 emits Sequential stacks")
    body = [f"    model.add({_emit_layer(layer, i == 0)})"
            for i, layer in enumerate(model.layers)]
    lines: List[str] = [
        '"""Keras-2 definition generated by analytics_zoo_tpu_torch '
        "saveToKeras2.",
        "",
        "Weight transplant:",
        "    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \\",
        "        keras2_export",
        "    tf_model = build_model()",
        "    tf_model.build((None,) + input_shape)",
        "    tf_model.set_weights(keras2_export.keras2_weights(zoo_model))",
        '"""',
        "from tensorflow import keras",
    ]
    if any("hard_sigmoid_k1" in line for line in body):
        # registered so a built model survives save()/load_model()
        lines += [
            "import tensorflow as tf",
            "",
            "try:",
            "    _register = keras.saving.register_keras_serializable",
            "except AttributeError:      # tf.keras 2.x",
            "    _register = keras.utils.register_keras_serializable",
            "",
            "",
            "@_register(package='analytics_zoo_tpu_torch')",
            "def hard_sigmoid_k1(x):",
            "    # Keras-1/BigDL hard_sigmoid (the zoo parity definition);",
            "    # modern keras redefined hard_sigmoid as relu6(x+3)/6",
            "    return tf.clip_by_value(0.2 * x + 0.5, 0.0, 1.0)",
        ]
    lines += [
        "",
        "",
        "def build_model():",
        f"    model = keras.Sequential(name={model.name!r})",
    ]
    lines += body
    lines += ["    return model", ""]
    return "\n".join(lines)
