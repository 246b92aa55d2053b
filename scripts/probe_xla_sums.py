"""Reveal how XLA's CPU backend sums the matrix products of the JAX
package's ORB pyramid, and hold the port's emulation of them
(`ra_slam_tpu_torch/features/pyramid.py:_XLA_SUMS`) to JAX bit for bit.
It needs both packages, so it runs where JAX is installed, never on a
machine with the port alone.

    python3 scripts/probe_xla_sums.py --out runs/xla_sums.json [--orb]

`ra_slam_tpu.features.pyramid.build_pyramid` resizes each level with
`jax.image.resize(..., "linear")`: one einsum of the image with two
weight matrices, run as two `dot_general`s (read from the jaxpr of each
level, with their shapes and contracted axes). For every product of the
pyramids the port builds (640x480 and 672x376 at 8 levels, 320x240 at
4), op by op as the JAX package's tests run it:

1. The summation tree of every output, over its nonzero taps. The order
   of a float sum does not depend on the values, so the probe picks
   them: ones, and +2^40 / -2^40 at a pair of taps, with the weight
   matrix's band of ones. An output then reads the number of taps
   outside the smallest subtree that holds both (the big pair cancels
   there; every one added to it before is absorbed), and those counts
   over all pairs of its taps give its tree. Pairs far apart share a
   call, so a product takes a few hundred calls. Nothing is assumed to
   depend only on (in, out): every output's tree is read.
2. The emulations of `_contract` (lanes 1-4, tap k in lane
   (k - start) % lanes, the lanes added pairwise; no split, or block
   starts on a grid of 8, one or two) whose trees equal the revealed ones
   at every output, the fewest lanes first, then the fewest starts.
3. Those fits in `_contract` against JAX's product on the product's
   inputs from three seeded noise images (numpy seeds 0-2): the first
   that is bit-equal is the entry. (A tree does not show which products
   are rounded before they are added: a fused multiply-add chain rounds
   only its first, a split also the first of each block.) Then, with the
   port's table as it stands: `_weight_mat` against
   `compute_weight_mat` at every (in, out), and every level and its blur
   against `build_pyramid` / `gaussian_blur` on the three images.
4. `--orb`: `detect_and_describe` against the JAX package's on frames 1,
   3 and 7 of the EVAL scene: 640x480 at the default `FeatureConfig`,
   672x376 at the live cell's 1000 keypoints on 3 levels (uv, level,
   score, valid, the valid keypoints' descriptors; the angle's largest
   difference). The JAX side compiles its ops one by one: ~4 min.

Prints the table's entries (the lines of `_XLA_SUMS`) and whether each
equals the port's, and writes everything with the CPU's `lscpu` model
name and core count to --out (the only file it writes). The order can
depend on the CPU's cache sizes and core count: the test machine must
give the table's. About 4 minutes on an 8-core CPU without --orb.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.extend import core as jcore  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ra_slam_tpu.features import pyramid as jpyr  # noqa: E402
from ra_slam_tpu_torch.features import pyramid as tpyr  # noqa: E402

SHAPES = ((640, 480, 8), (672, 376, 8), (320, 240, 4))  # (width, height, levels)
SEEDS = (0, 1, 2)
BIG = np.float32(2.0**40)
MAX_TRIED = 64  # fits tried on the seeded inputs, in order
HI = jax.lax.Precision.HIGHEST


def _resize(img, h, w):
    return jax.image.resize(img, (h, w), method="linear", precision=HI)


def products(img: np.ndarray, h: int, w: int):
    """[(kind, x [other, in], in, out, JAX's product [other, out])] of
    one level, each `dot_general` of its jaxpr evaluated op by op."""
    closed = jax.make_jaxpr(lambda x: _resize(x, h, w))(jnp.asarray(img))
    dots = []

    def run(jaxpr, consts, args):
        env = dict(zip(jaxpr.constvars, consts)) | dict(zip(jaxpr.invars, args))
        read = lambda v: v.val if isinstance(v, jcore.Literal) else env[v]
        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            sub = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if sub is not None:
                outs = run(sub.jaxpr, sub.consts, ins)
            else:
                with jax.disable_jit():
                    outs = eqn.primitive.bind(*ins, **eqn.params)
                outs = outs if eqn.primitive.multiple_results else [outs]
                if eqn.primitive.name == "dot_general":
                    a, b, o = (np.asarray(t) for t in (ins[0], ins[1], outs[0]))
                    if eqn.params["dimension_numbers"][0] == ((0,), (0,)):  # weights^T @ image: the rows
                        dots.append(("rows", b.T, a.shape[0], a.shape[1], o.T))
                    else:  # image @ weights: the columns
                        dots.append(("cols", a, b.shape[0], b.shape[1], o))
            env.update(zip(eqn.outvars, outs))
        return [read(v) for v in jaxpr.outvars]

    run(closed.jaxpr, closed.consts, [jnp.asarray(img)])
    return dots


def _band(in_size: int, out_size: int):
    nz = tpyr._weight_mat(in_size, out_size) != 0
    return nz.argmax(0), in_size - 1 - nz[::-1].argmax(0)


def _dot(kind: str, x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """JAX's product as the einsum calls it: x [other, in], w [in, out]
    -> [other, out]."""
    with jax.disable_jit():
        if kind == "rows":
            return np.asarray(jax.lax.dot_general(jnp.asarray(w), jnp.asarray(x.T), (((0,), (0,)), ((), ())),
                                                  precision=HI)).T
        return np.asarray(jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
                                              precision=HI))


def _tree(lca: np.ndarray, leaves: list):
    """Rooted binary tree over `leaves` from the sizes of the smallest
    subtrees holding each pair; children ordered by their first leaf."""
    if len(leaves) == 1:
        return leaves[0]
    groups, seen = [], set()
    for a in leaves:
        if a in seen:
            continue
        group, stack = [a], [a]
        seen.add(a)
        while stack:
            x = stack.pop()
            for b in leaves:
                if b not in seen and lca[x, b] < len(leaves):
                    seen.add(b)
                    group.append(b)
                    stack.append(b)
        groups.append(sorted(group))
    assert len(groups) == 2, groups
    return tuple(_tree(lca, g) for g in sorted(groups))


def reveal_trees(kind: str, in_size: int, out_size: int, other: int) -> list:
    """Each output's summation tree over its taps (relative to its first),
    from cancellation probes (module docstring, step 1)."""
    first, last = _band(in_size, out_size)
    n = last - first + 1
    taps = int(n.max())
    band = np.zeros((in_size, out_size), np.float32)
    for j in range(out_size):
        band[first[j]:last[j] + 1, j] = 1
    lca = [np.full((n[j], n[j]), 1, np.int64) for j in range(out_size)]
    for d in range(1, taps):
        for r in range(2 * taps):  # pairs 2 * taps apart: no band holds two
            ps = np.arange(r, in_size - d, 2 * taps)
            if not len(ps):
                continue
            vals = np.ones(in_size, np.float32)
            vals[ps], vals[ps + d] = BIG, -BIG
            got = _dot(kind, np.broadcast_to(vals, (other, in_size)).copy(), band)
            for p in ps:
                for j in np.nonzero((first <= p) & (last >= p + d))[0]:
                    col = got[:, j]
                    assert (col == col[0]).all() and abs(col[0]) < 1e6, (kind, in_size, out_size, j, p, d)
                    a = p - first[j]
                    lca[j][a, a + d] = lca[j][a + d, a] = n[j] - int(col[0])
    return [_tree(lca[j], list(range(n[j]))) for j in range(out_size)]


def _leaves(t):
    return [t] if isinstance(t, int) else _leaves(t[0]) + _leaves(t[1])


def model_tree(f: int, l: int, lanes: int, starts: tuple):
    """The tree `_contract` sums taps f..l in (relative leaves)."""
    edges = [0, *starts, 10**9]
    join = lambda a, b: b if a is None else a if b is None else (a, b)
    out = None
    for s, e in zip(edges[:-1], edges[1:]):
        lane = [None] * lanes
        for k in range(max(f, s), min(l, e - 1) + 1):
            lane[(k - s) % lanes] = join(lane[(k - s) % lanes], k - f)
        while len(lane) > 1:
            lane = [join(a, b) for a, b in zip(lane[::2], lane[1::2])] + lane[len(lane) - len(lane) % 2:]
        out = join(out, lane[0])

    def canon(t):
        if isinstance(t, int):
            return t
        a, b = canon(t[0]), canon(t[1])
        return (a, b) if min(_leaves(a)) < min(_leaves(b)) else (b, a)

    return canon(out)


def fit(in_size: int, out_size: int, trees: list) -> list:
    """Every (lanes, starts) whose trees equal the revealed ones, for the
    fewest lanes that fit any."""
    first, last = _band(in_size, out_size)
    grid = range(8, in_size, 8)
    for lanes in (1, 2, 3, 4):
        hits = [(lanes, starts) for ns in (0, 1, 2) for starts in itertools.combinations(grid, ns)
                if all(model_tree(int(first[j]), int(last[j]), lanes, starts) == trees[j]
                       for j in range(out_size))]
        if hits:
            return sorted(hits, key=lambda h: (len(h[1]), h[1]))
    return []


def contract_with(entry, x: np.ndarray, in_size: int, out_size: int) -> np.ndarray:
    """The port's `_contract` with `entry` in the table for this product."""
    key = (in_size, out_size, x.shape[0])
    saved = tpyr._XLA_SUMS.get(key)
    tpyr._XLA_SUMS[key] = entry
    tpyr._lane_taps.cache_clear()
    tpyr._device_taps.cache_clear()
    try:
        return tpyr._contract(torch.from_numpy(np.array(x)), in_size, out_size).numpy()
    finally:
        tpyr._XLA_SUMS.pop(key)
        if saved is not None:
            tpyr._XLA_SUMS[key] = saved
        tpyr._lane_taps.cache_clear()
        tpyr._device_taps.cache_clear()


def _noise(width: int, height: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((height, width)) * 255).astype(np.float32)


def probe_products() -> list:
    rows = []
    for width, height, levels in SHAPES:
        for h, w in tpyr.pyramid_shapes(height, width, levels, 1.2)[1:]:
            per_seed = [products(_noise(width, height, s), h, w) for s in SEEDS]
            for i, (kind, x, in_size, out_size, _) in enumerate(per_seed[0]):
                t0 = time.perf_counter()
                other = x.shape[0]
                trees = reveal_trees(kind, in_size, out_size, other)
                hits = fit(in_size, out_size, trees)
                # a tree does not show which products are rounded before
                # they are added (a chain's first, a block's first): the
                # seeded inputs decide between the fits
                entry = next((h for h in hits[:MAX_TRIED] if all(
                    np.array_equal(contract_with(h, p[i][1], in_size, out_size), p[i][4]) for p in per_seed)), None)
                equal = entry is not None
                entry = entry or (hits[0] if hits else None)
                table = tpyr._XLA_SUMS.get((in_size, out_size, other), (1, ()))
                rows.append({
                    "image": f"{width}x{height}", "level": f"{w}x{h}", "kind": kind, "in": in_size,
                    "out": out_size, "other": other, "lanes": entry[0] if entry else None,
                    "starts": list(entry[1]) if entry else None, "fits": len(hits),
                    "distinct_trees": len(set(trees)), "seeds_bit_equal": bool(equal),
                    "table": [table[0], list(table[1])],
                    "table_equal": bool(entry is not None and tuple(table) == (entry[0], tuple(entry[1]))),
                    "seconds": round(time.perf_counter() - t0, 1),
                })
                print(json.dumps(rows[-1]), flush=True)
    return rows


def check_port() -> dict:
    """The port's table as it stands: weights and every level and blur."""
    from jax._src.image import scale

    out = {"weights_unequal": [], "levels_unequal": []}
    kernel = scale._kernels[scale.ResizeMethod.LINEAR]
    for width, height, levels in SHAPES:
        for h, w in tpyr.pyramid_shapes(height, width, levels, 1.2)[1:]:
            for i, o in ((height, h), (width, w)):
                with jax.disable_jit():
                    ref = np.asarray(scale.compute_weight_mat(i, o, o / i, 0.0, kernel, True))
                if not np.array_equal(tpyr._weight_mat(i, o), ref):
                    out["weights_unequal"].append([i, o, int((tpyr._weight_mat(i, o) != ref).sum())])
        for seed in SEEDS:
            img = _noise(width, height, seed)
            with jax.disable_jit():
                jl = [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(img), levels, 1.2)]
                jb = [np.asarray(jpyr.gaussian_blur(x)) for x in jl]
            tl = [x.numpy() for x in tpyr.build_pyramid(torch.from_numpy(img), levels, 1.2)]
            for lvl, (a, b, bb) in enumerate(zip(tl, jl, jb)):
                blur = tpyr.gaussian_blur(torch.from_numpy(a)).numpy()
                if not (np.array_equal(a, b) and np.array_equal(blur, bb)):
                    out["levels_unequal"].append({
                        "image": f"{width}x{height}", "seed": seed, "level": lvl,
                        "pixels": int((a != b).sum()), "max": float(np.abs(a - b).max()),
                        "blur_pixels": int((blur != bb).sum())})
    return out


def check_orb() -> list:
    from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
    from ra_slam_tpu.features import orb as jorb
    from ra_slam_tpu_torch.core.config import FeatureConfig
    from ra_slam_tpu_torch.features import orb as torb
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    rows = []
    for width, height, kw in ((640, 480, {}), (672, 376, dict(max_num_keypoints=1000, num_levels=3))):
        f = width / 2.0
        spec = SyntheticCameraSpec(fx=f, fy=f, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width,
                                   height=height)
        ds = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, clutter=6)
        for index in (1, 3, 7):
            with jax.disable_jit():
                gray = jpyr.rgb_to_gray(jnp.asarray(ds.frame(index).rgb, jnp.float32))
                kj = jorb.detect_and_describe(gray, JaxFeatureConfig(**kw))
            kt = torb.detect_and_describe(torch.from_numpy(np.array(gray)), FeatureConfig(**kw))
            v = np.asarray(kj.valid)
            row = {"image": f"{width}x{height}", "frame": index, "levels": FeatureConfig(**kw).num_levels,
                   "valid": int(v.sum())}
            for name in ("uv", "level", "score", "valid"):
                row[f"{name}_unequal"] = int((getattr(kt, name).numpy() != np.asarray(getattr(kj, name))).sum())
            row["desc_unequal"] = int((kt.desc.numpy().view(np.uint32) != np.asarray(kj.desc))[v].sum())
            row["angle_max_diff"] = float(np.abs(kt.angle.numpy() - np.asarray(kj.angle))[v].max())
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--orb", action="store_true")
    args = p.parse_args()
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    model = next((ln.split(":", 1)[1].strip() for ln in lscpu.splitlines() if ln.startswith("Model name")), "?")
    result = {"cpu": model, "cores": os.cpu_count(), "jax": jax.__version__, "products": probe_products()}
    print("_XLA_SUMS entries:")
    for r in result["products"]:
        print(f"    ({r['in']}, {r['out']}, {r['other']}): ({r['lanes']}, {tuple(r['starts'])}),"
              f"  # {r['image']} {r['kind']}; {'in' if r['table_equal'] else 'NOT in'} the table")
    result["port"] = check_port()
    print(json.dumps(result["port"]))
    if args.orb:
        result["orb"] = check_orb()
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    ok = all(r["seeds_bit_equal"] and r["table_equal"] for r in result["products"]) and not any(
        result["port"].values())
    print(f"{model}, {os.cpu_count()} cores, jax {jax.__version__}: "
          f"{'every product, weight, level and blur bit-equal' if ok else 'NOT all bit-equal'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
