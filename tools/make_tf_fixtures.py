"""Write a frozen TensorFlow graph, its seeded inputs and TensorFlow's rows
of them, for the places that load a graph TensorFlow wrote where no
TensorFlow is installed (``chip_smoke.py``'s interop leg E, the ``gpu``
test of ``tests/test_torch_gpu.py``).

    python tools/make_tf_fixtures.py [--out tools/tf_fixtures]

Needs TensorFlow (the machine that writes the files, not the ones that
read them). The graph is a small NHWC image classifier traced with
``tf.function`` over seeded ``tf.Variable``s and frozen with
``convert_variables_to_constants_v2``; its ops stay inside the port's
registry: ``Conv2D`` (SAME, stride 2), ``DepthwiseConv2dNative``,
``FusedBatchNormV3`` (``tf.nn.fused_batch_norm(is_training=False)``),
``Relu6``, ``MaxPool`` and ``AvgPool`` under SAME, ``Mean``, a
dynamic-batch ``Reshape`` (``Shape`` -> ``StridedSlice`` -> ``Pack``),
``MatMul``, ``BiasAdd`` and ``Softmax``. Files: ``classifier.pb``,
``inputs.npy`` (8 x 32 x 32 x 3 float32), ``rows.npy`` (TensorFlow's
softmax rows of them, run on the CPU) and ``manifest.json`` (TF's
version, the op set, shapes, input/output names, SHA-256 of each file).
"""

import argparse
import hashlib
import json
import os

import numpy as np

SEED = 22
BATCH, SIDE, CLASSES = 8, 32, 10


def build(tf):
    rs = np.random.default_rng(SEED)

    def var(shape, scale):
        return tf.Variable(rs.normal(0, scale, shape).astype(np.float32))

    w_conv = var((3, 3, 3, 16), 0.3)
    b_conv = var((16,), 0.1)
    w_dw = var((3, 3, 16, 1), 0.3)
    gamma = tf.Variable(rs.uniform(0.5, 1.5, 16).astype(np.float32))
    beta = var((16,), 0.1)
    mean = var((16,), 0.1)
    variance = tf.Variable(rs.uniform(0.5, 2.0, 16).astype(np.float32))
    w_flat = var((8 * 8 * 16, CLASSES), 0.05)
    w_mean = var((16, CLASSES), 0.3)
    b_out = var((CLASSES,), 0.1)

    @tf.function(input_signature=[tf.TensorSpec((None, SIDE, SIDE, 3),
                                                 tf.float32, name="image")])
    def classify(image):
        x = tf.nn.conv2d(image, w_conv, strides=2, padding="SAME")
        x = tf.nn.bias_add(x, b_conv)
        x = tf.nn.depthwise_conv2d(x, w_dw, strides=[1, 1, 1, 1],
                                   padding="SAME")
        x, _, _ = tf.compat.v1.nn.fused_batch_norm(
            x, gamma, beta, mean=mean, variance=variance, epsilon=1e-3,
            is_training=False)
        x = tf.nn.relu6(x)
        x = tf.nn.max_pool2d(x, 2, 2, padding="SAME")
        x = tf.nn.avg_pool2d(x, 3, 1, padding="SAME")
        pooled = tf.reduce_mean(x, axis=[1, 2])
        flat = tf.reshape(x, tf.stack([tf.shape(x)[0], -1]))
        logits = tf.matmul(flat, w_flat) + tf.matmul(pooled, w_mean)
        return tf.nn.softmax(tf.nn.bias_add(logits, b_out), name="probs")

    # the variables live as long as the concrete function's caller holds
    # them
    return classify.get_concrete_function(), [
        w_conv, b_conv, w_dw, gamma, beta, mean, variance, w_flat, w_mean,
        b_out]


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tf_fixtures"))
    args = ap.parse_args()
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2

    concrete, _variables = build(tf)
    frozen = convert_variables_to_constants_v2(concrete)
    graph_def = frozen.graph.as_graph_def()
    os.makedirs(args.out, exist_ok=True)
    pb = os.path.join(args.out, "classifier.pb")
    with open(pb, "wb") as f:
        f.write(graph_def.SerializeToString())
    x = np.random.default_rng(SEED + 1).standard_normal(
        (BATCH, SIDE, SIDE, 3)).astype(np.float32)
    with tf.device("/CPU:0"):
        rows = frozen(tf.constant(x))[0].numpy()
    np.save(os.path.join(args.out, "inputs.npy"), x)
    np.save(os.path.join(args.out, "rows.npy"), rows)
    manifest = {
        "tensorflow": tf.__version__,
        "writer": "tools/make_tf_fixtures.py",
        "graph": "classifier.pb",
        "inputs": [t.name for t in frozen.inputs],
        "outputs": [t.name for t in frozen.outputs],
        "ops": sorted({n.op for n in graph_def.node}),
        "input_shape": list(x.shape), "rows_shape": list(rows.shape),
        "sha256": {name: sha256(os.path.join(args.out, name)) for name in
                   ("classifier.pb", "inputs.npy", "rows.npy")},
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(json.dumps(manifest))


if __name__ == "__main__":
    main()
