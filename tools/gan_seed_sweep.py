"""How often tests/test_tfpark.py's 1-D Gaussian GAN lands within 1.0 of
3.0 after 150 steps, over seeds, in the JAX package or in the port.

Each seed trains the test's GAN (Dense(16, relu) -> Dense(1) on each side,
noise 4, Adam 5e-3 both sides) on the same 512 rows of N(3, 0.5) at batch
64 for 150 steps, then prints the mean of 256 generated samples. In the
port the seed sets both models' initial weights and the noise; in the JAX
package it sets the estimator's key (weights and noise). On the CPU:

    PYTHONPATH=. python tools/gan_seed_sweep.py --package torch --seeds 40
    PYTHONPATH=. python tools/gan_seed_sweep.py --package jax --seeds 40

Prints one JSON line: the means, and how many lie outside 3.0 +- 1.0.
"""

import argparse
import json

import numpy as np


def sweep(package: str, seeds: int):
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu.pipeline.api.keras.models import Sequential
        from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam
        from analytics_zoo_tpu.tfpark import GANEstimator
    else:
        from analytics_zoo_tpu_torch.common.nncontext import init_nncontext
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
            Sequential
        from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
        from analytics_zoo_tpu_torch.tfpark import GANEstimator

        init_nncontext(device="cpu")
    real = (np.random.default_rng(0).standard_normal((512, 1)) * 0.5
            + 3.0).astype(np.float32)
    means = []
    for seed in range(seeds):
        kw = {} if package == "jax" else dict(seed=seed)
        gen, disc = Sequential(**kw), Sequential(**kw)
        gen.add(Dense(16, activation="relu", input_shape=(4,)))
        gen.add(Dense(1))
        disc.add(Dense(16, activation="relu", input_shape=(1,)))
        disc.add(Dense(1))
        est = GANEstimator(gen, disc, generator_optimizer=Adam(lr=5e-3),
                           discriminator_optimizer=Adam(lr=5e-3),
                           noise_dim=4, seed=seed)
        est.train(real, steps=150, batch_size=64)
        means.append(float(est.generate(256).mean()))
    return means


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--seeds", type=int, default=40)
    args = ap.parse_args()
    means = sweep(args.package, args.seeds)
    print(json.dumps({"package": args.package, "seeds": args.seeds,
                      "means": means,
                      "outside": sum(abs(m - 3.0) >= 1.0 for m in means)}))


if __name__ == "__main__":
    main()
