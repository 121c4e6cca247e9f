"""The cases of the dist-substrate fixture, in numpy alone, shared by its
maker (``tests/fixtures/torch_dist/make_fixture.py``, JAX) and the port's
tests (``tests/test_torch_dist.py``, ``tests/test_torch_dryrun.py``).

Every input is drawn here from a numpy seed, so the fixture holds only the
JAX package's outputs; the SHA-256 of this file is in the fixture, and a
test refuses a fixture made from another version of it.  The cases are
those of ``tests/spmd_programs.py``'s collective-matmul, pipeline and
transformer programs.
"""
import zlib

import numpy as np

# collective_matmul_ag over the 'model' axis of ("data", "model") meshes
CM = dict(S=16, K=32, O=24)
MESHES = ((2, 4), (4, 2))
# tp_matmul_ag of a (B, S, K) activation, under the same meshes
TP = dict(B=4, S=8, K=16, O=24)
# pipeline_apply over a ("pod", "model") mesh, the stages on 'pod'
PIPE = dict(mesh=(4, 2), M=6, mb=3, d=8)
# the tiny float32 LM of prog_cm_transformer, forward over (B, S) tokens
# under {"seq": "model"}, with and without use_collective_matmul
LM = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
          d_head=16, d_ff=128, vocab=64, remat=False)
LM_B, LM_S = 4, 8
LM_RULES = {"seq": "model"}
# build_cell's shapes, specs and model_flops at reduced size on this mesh;
# the op counts on the (1, 1) mesh
CELL_MESH = (2, 4)


def cm_inputs():
    """x (S, K), w (K, O) float32."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((CM["S"], CM["K"])).astype(np.float32),
            rng.standard_normal((CM["K"], CM["O"])).astype(np.float32))


def tp_inputs():
    """x (B, S, K), w (K, O) float32."""
    rng = np.random.default_rng(2)
    return (rng.standard_normal((TP["B"], TP["S"], TP["K"]))
            .astype(np.float32),
            rng.standard_normal((TP["K"], TP["O"])).astype(np.float32))


def pipe_inputs():
    """x (M, mb, d), the four stages' weights (4, d, d) float32."""
    rng = np.random.default_rng(3)
    M, mb, d = PIPE["M"], PIPE["mb"], PIPE["d"]
    return (rng.standard_normal((M, mb, d)).astype(np.float32),
            (rng.standard_normal((4, d, d)) * 0.3).astype(np.float32))


def pipe_reference(x, ws):
    """The four stages applied in sequence (numpy)."""
    for w in ws:
        x = np.tanh(x @ w)
    return x


def lm_param(path: str, shape) -> np.ndarray:
    """A leaf of the tiny LM, drawn from a seed of its path ("blocks/0/wq"):
    N(0, 1 / fan_in), and 1 + N(0, 0.1) for the ln scales."""
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    z = rng.standard_normal(shape)
    if path.split("/")[-1].startswith("ln"):
        return (1.0 + 0.1 * z).astype(np.float32)
    return (z * shape[-2] ** -0.5).astype(np.float32)


def lm_tokens():
    return np.random.default_rng(4).integers(
        0, LM["vocab"], (LM_B, LM_S)).astype(np.int32)
