"""The cases of the LM-zoo fixture, in numpy alone, shared by its maker
(``tests/fixtures/torch_lm_zoo/make_fixture.py``, JAX) and the port's tests
(``tests/test_torch_moe.py``, ``tests/test_torch_lm_zoo.py``).

Every input is drawn here from a numpy seed, so the fixture holds only the
JAX package's outputs; the SHA-256 of this file is in the fixture, and a
test refuses a fixture made from another version of it.
"""
import numpy as np

# moe_ffn cases: T tokens of width D, E experts of hidden F; capacity
# factor 1.0 and a skewed router (moe_inputs) so that every case drops
# pairs; token TIED is all zeros (its router logits are equal: the tie
# order decides its experts)
MOE = dict(T=64, E=8, D=32, F=48, capacity_factor=1.0)
TIED = 5
MOE_CASES = [(f"k{k}_g{g}_{dt}", k, g, dt)
             for k in (1, 2) for g in (0, 4)
             for dt in ("float32", "bfloat16")]

# the four LM archs of this fixture, at REDUCED; forward / prefill over
# (B, S) tokens, decode DECODE_STEPS steps from an empty cache of S slots
LM_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "qwen1.5-32b", "llama3-405b")
LM_B, LM_S, DECODE_STEPS = 2, 16, 4
N_PROJ = 4          # random projections kept of each gradient leaf

# a1_ship_lookup: a (2, 4) mesh (tests/spmd_programs.py:384-397) and a
# V x D table, ids with padding
SHIP = dict(mesh=(2, 4), V=64, D=16, n_ids=10)
# ef_compress_grads under shard_map over the 8 shards, two rounds
EF_SHARDS, EF_ROUNDS = 8, 2


def bf16_round(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def moe_inputs(name: str) -> dict:
    """x, router_w, we1, we3, we2 of a case, float32 (bf16 cases: values
    rounded to bf16)."""
    idx = [c[0] for c in MOE_CASES].index(name)
    dt = MOE_CASES[idx][3]
    rng = np.random.default_rng(100 + idx)
    T, E, D, F = MOE["T"], MOE["E"], MOE["D"], MOE["F"]
    out = dict(x=rng.standard_normal((T, D)),
               router_w=rng.standard_normal((D, E)) * D ** -0.5,
               we1=rng.standard_normal((E, D, F)) * D ** -0.5,
               we3=rng.standard_normal((E, D, F)) * D ** -0.5,
               we2=rng.standard_normal((E, F, D)) * F ** -0.5)
    # skew: a shared offset of the tokens that expert 0's router column
    # favours, so that groups of 16 tokens overflow a capacity of 8 too
    out["x"] += 0.5
    out["router_w"][:, 0] = np.abs(out["router_w"][:, 0])
    out["x"][TIED] = 0.0
    out = {k: v.astype(np.float32) for k, v in out.items()}
    if dt == "bfloat16":
        out = {k: bf16_round(v) for k, v in out.items()}
    return out


def lm_params(shapes: list, seed: int) -> list:
    """One array a (path, shape) of ``shapes`` (the tree's leaves in
    order): embed N(0, 1), ln scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1),
    every matrix (the router and the experts too) N(0, 1) * fan_in^-0.5."""
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in shapes:
        name = path[-1]
        z = rng.standard_normal(shape)
        if name == "embed":
            a = z
        elif name in ("ln1", "ln2", "ln_f"):
            a = 1 + 0.1 * z
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * z
        else:
            a = z * shape[-2] ** -0.5
        out.append(a.astype(np.float32))
    return out


def lm_tokens(vocab: int, seed: int):
    """(tokens, targets) int32 (B, S): targets shifted by one, the last
    position of row 0 padded (-1)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (LM_B, LM_S + 1)).astype(np.int32)
    tgt = t[:, 1:].copy()
    tgt[0, -1] = -1
    return t[:, :-1].copy(), tgt


def projections(shape, seed: int):
    """N_PROJ fixed random unit-variance directions of a leaf: (N_PROJ,
    size) float64."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N_PROJ, int(np.prod(shape))))


def ship_inputs():
    rng = np.random.default_rng(7)
    table = rng.standard_normal((SHIP["V"], SHIP["D"])).astype(np.float32)
    ids = rng.integers(-3, SHIP["V"], SHIP["n_ids"]).astype(np.int32)
    ids[[1, 6]] = -1
    return table, ids


def ef_inputs():
    """Per-shard gradient trees and first error states, stacked on a
    leading shard axis: shard s's gradients scaled by 2 ** (s - 3) times a
    random factor, so every shard has its own scale; one leaf bfloat16."""
    rng = np.random.default_rng(8)
    S = EF_SHARDS
    scale = (2.0 ** (np.arange(S) - 3) * rng.uniform(0.5, 1.5, S))
    g = {"a": rng.standard_normal((S, 6, 5)) * scale[:, None, None],
         "b": [rng.standard_normal((S, 7)) * scale[:, None]],
         "c": rng.standard_normal((S, 4, 3)) * scale[:, None, None]}
    e = {"a": rng.standard_normal((S, 6, 5)) * 1e-3,
         "b": [np.zeros((S, 7))],
         "c": rng.standard_normal((S, 4, 3)) * 1e-3}
    g = {"a": g["a"].astype(np.float32), "b": [g["b"][0].astype(np.float32)],
         "c": bf16_round(g["c"].astype(np.float32))}
    e = {"a": e["a"].astype(np.float32), "b": [e["b"][0].astype(np.float32)],
         "c": e["c"].astype(np.float32)}
    return g, e
