"""JAX's K6 on the one window and head that tools/k6_draws.py wrote (--out),
on the CPU, beside the card's outputs and the float64 evaluations.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/_torch_k6_window_jax.py DIR/k6_worst_draw.npz

Runs dlimgedit_tpu/ops/flash_attention.py `windowed_attention_fused` in
interpret mode (as the JAX suite's tests run it) on the window's bf16 q, k,
v and the tables, one head, and prints, at the output of largest |kernel -
plain| and over the window and head, each of the kernel, the plain version
and JAX against the float64 evaluations (`exact`: the bias halves
correctly rounded, the rest exact; `jax`: p rounded too), in steps of bf16
at the output's own magnitude and at the group's largest, and the bias
halves of that output's row: float64, correctly rounded, JAX's float32
sums rounded.
"""

import sys

import jax.numpy as jnp
import numpy as np

from dlimgedit_tpu.ops.flash_attention import windowed_attention_fused


def step(x):
    """One bf16 step at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def main(path: str) -> int:
    d = np.load(path)
    ws = int(d["ws"])
    ty, tx = (int(t) for t in d["token"])
    ch = int(d["channel"])

    def bf(name):
        return jnp.asarray(d[name].astype(np.float32)).astype(jnp.bfloat16)

    out = windowed_attention_fused(bf("q"), bf("k"), bf("v"), bf("rh"), bf("rw"), ws=ws,
                                   num_heads=1, interpret=True)
    jx = np.asarray(out.astype(jnp.float32))[0].astype(np.float64)
    kern, plain, exact, jref = (d[n][0] for n in ("kernel", "plain", "exact", "jax"))
    g = step(np.abs(exact).max())
    window = tuple(int(t) for t in d["window"])
    print(f"seed {int(d['seed'])}, window {window}, head {int(d['head'])}, "
          f"token {(ty, tx)} of the window, channel {ch}; the group's largest "
          f"|exact| {np.abs(exact).max():.4f} (a step {g})")
    for name, x in (("kernel", kern), ("plain", plain), ("JAX", jx)):
        at = x[ty, tx, ch]
        print(f"{name}: {at:.6f}; {abs(at - exact[ty, tx, ch]) / step(exact[ty, tx, ch]):.2f} / "
              f"{abs(at - jref[ty, tx, ch]) / step(jref[ty, tx, ch]):.2f} steps (its own "
              f"magnitude) from exact / jax; over the window and head "
              f"{np.abs(x - exact).max() / g:.3f} / {np.abs(x - jref).max() / g:.3f} group "
              f"steps; max |{name} - kernel| {np.abs(x - kern).max():.5f}, "
              f"|{name} - plain| {np.abs(x - plain).max():.5f}")
    print(f"exact {exact[ty, tx, ch]:.6f}, jax {jref[ty, tx, ch]:.6f}")
    q = d["q"][0].reshape(ws * ws, -1)[ty * ws + tx]
    for label, table in (("bh", d["rh"][ty]), ("bw", d["rw"][tx])):
        f64 = table @ q
        mine = np.asarray(jnp.asarray(f64.astype(np.float32)).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        jsum = jnp.sum(jnp.asarray(q, jnp.float32)[None] * jnp.asarray(table, jnp.float32), -1)
        jround = np.asarray(jsum.astype(jnp.bfloat16).astype(jnp.float32))
        apart = np.nonzero(jround != mine)[0]
        print(f"{label}: JAX's float32 sums round apart from the float64 sums (rounded "
              f"once more through float32) at columns {apart.tolist()}: "
              + ", ".join(f"{f64[i]:.7f} -> {mine[i]:g} / {jround[i]:g}" for i in apart))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
