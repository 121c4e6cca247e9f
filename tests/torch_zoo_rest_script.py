"""The cases of the zoo-remainder fixture, in numpy alone, shared by its
maker (``tests/fixtures/torch_zoo_rest/make_fixture.py``, JAX) and the
port's tests (``tests/test_torch_mgn_nequip.py``,
``tests/test_torch_sampler.py``).

Every input is drawn here from a numpy seed, so the fixture holds only the
JAX package's outputs; the SHA-256 of this file is in the fixture, and a
test refuses a fixture made from another version of it.
"""
import numpy as np

# MeshGraphNet and NequIP at small configs (MGNConfig / NequIPConfig
# fields); each model's cases are graphs of graph_case's kinds
MGN_CFG = dict(name="mgn-small", n_layers=2, d_in=6, d_edge_in=4,
               d_hidden=16, d_out=3, mlp_layers=2)
NEQUIP_CFG = dict(name="nequip-small", n_layers=2, mul=8, l_max=2, n_rbf=4,
                  cutoff=5.0, n_species=4, radial_hidden=8)
MGN_CASES = ("positions", "edge_feat")
NEQUIP_CASES = ("graphs", "one_graph")
N_NODES, N_EDGES, N_PAD = 24, 72, 6
N_GRAPHS = 3

# the cells of the two archs, each at both sizes
CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
TRAIN_ARCHS = ("meshgraphnet", "nequip")
TRAIN_SHAPE = {"meshgraphnet": "full_graph_sm", "nequip": "molecule"}
BATCH_ARCHS = ("gcn-cora", "meshgraphnet", "nequip")   # _batch_source
BATCH_DRAWS = 2

# fanout_sample: a graph whose last nodes have no out-edges, seeds with a
# -1 and zero-degree nodes (the last node among them)
SAMPLE = dict(n=40, n_src=34, e=200, fanouts=(3, 2), key=11, d_feat=5,
              n_classes=6)
SAMPLE_SEEDS = (3, -1, 39, 0, 35, 17, 33, 21)

# fanout_sample_db over a film KG written by each package's loader
DB_CFG = dict(n_shards=4, cap_v=64, cap_e=512, cap_delta=512, cap_idx=128,
              cap_idx_delta=64, d_f32=2, d_i32=2)
DB_KG = dict(n_films=40, n_actors=60, n_directors=8, n_genres=4, seed=5)
DB_CASES = (((0, 1, 2, -1, 5), (4, 3), -1, 0),       # seeds, fanouts,
            ((0, 3, 7), (2, 2), 0, 9))                # etype, seed


def tree_params(leaves: list, seed: int) -> list:
    """One array a (path, shape) of ``leaves`` (a tree's leaves in order):
    matrices N(0, 1/fan_in), LayerNorm scales 1 + 0.1 N(0, 1), every other
    1-D leaf 0.1 N(0, 1) (so that biases matter)."""
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in leaves:
        z = rng.standard_normal(shape)
        if len(shape) > 1:
            a = z * shape[-2] ** -0.5
        elif path[-1] == "ln_scale":
            a = 1 + 0.1 * z
        else:
            a = 0.1 * z
        out.append(a.astype(np.float32))
    return out


def graph_case(kind: str, seed: int) -> dict:
    """A padded COO graph as numpy arrays, GraphBatch's fields:
    ``N_NODES`` nodes, ``N_EDGES`` edges of which the last ``N_PAD`` are
    padding (src -1, dst 0) and the first the one self-loop.  Kinds: MGN
    ``positions`` / ``edge_feat`` (node regression targets (N, 3), half
    the nodes trained on), NequIP ``graphs`` (``N_GRAPHS`` molecules,
    species in node_feat[:, 0], energies, one graph off the mask) and
    ``one_graph`` (no graph_ids)."""
    rng = np.random.default_rng(seed)
    n, e = N_NODES, N_EDGES
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst = np.where(dst == src, (dst + 1) % n, dst).astype(np.int32)
    dst[0] = src[0]                               # the one self-loop
    src[e - N_PAD:] = -1
    dst[e - N_PAD:] = 0
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    out = dict(edge_src=src, edge_dst=dst, positions=pos)
    if kind in MGN_CASES:
        out["node_feat"] = rng.standard_normal(
            (n, MGN_CFG["d_in"])).astype(np.float32)
        out["labels"] = rng.standard_normal((n, 3)).astype(np.float32)
        out["train_mask"] = rng.uniform(size=n) < 0.5
        if kind == "edge_feat":
            out["edge_feat"] = rng.standard_normal(
                (e, MGN_CFG["d_edge_in"])).astype(np.float32)
        out["n_graphs"] = 1
        return out
    g = N_GRAPHS if kind == "graphs" else 1
    out["node_feat"] = rng.integers(0, NEQUIP_CFG["n_species"],
                                    (n, 1)).astype(np.float32)
    out["labels"] = rng.standard_normal(g).astype(np.float32)
    out["train_mask"] = np.arange(g) != 1 if g > 1 else np.ones(1, bool)
    if kind == "graphs":
        out["graph_ids"] = np.repeat(np.arange(g), n // g).astype(np.int32)
    out["n_graphs"] = g
    return out


def train_batch(arch: str, geometry: tuple, seed: int) -> dict:
    """A GraphBatch's fields for one train step of ``arch`` at a reduced
    cell's ``geometry`` (nodes, edges, features, graphs): random edges
    with the last 8 padding, MGN's (N, 3) targets or NequIP's species and
    per-graph energies, positions."""
    rng = np.random.default_rng(seed)
    n, e, d, g = geometry
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[-8:] = -1
    out = dict(edge_src=src, edge_dst=dst, n_graphs=g,
               positions=rng.standard_normal((n, 3)).astype(np.float32))
    if arch == "meshgraphnet":
        out["node_feat"] = rng.standard_normal((n, d)).astype(np.float32)
        out["labels"] = rng.standard_normal((n, 3)).astype(np.float32)
        out["train_mask"] = np.ones(n, bool)
    else:
        feat = np.zeros((n, d), np.float32)
        feat[:, 0] = rng.integers(0, 4, n)
        out["node_feat"] = feat
        out["labels"] = rng.standard_normal(g).astype(np.float32)
        out["train_mask"] = np.ones(g, bool)
        out["graph_ids"] = np.repeat(np.arange(g), n // g).astype(np.int32)
    return out


def sample_graph():
    """(src, dst) int32 of the sampler's graph: sources among the first
    ``n_src`` nodes only, so the last nodes have no out-edges."""
    rng = np.random.default_rng(SAMPLE["key"])
    src = rng.integers(0, SAMPLE["n_src"], SAMPLE["e"]).astype(np.int32)
    dst = rng.integers(0, SAMPLE["n"], SAMPLE["e"]).astype(np.int32)
    return src, dst


def sample_data():
    """(features (n, d_feat) float32, labels (n,) int32)."""
    rng = np.random.default_rng(SAMPLE["key"] + 1)
    return (rng.standard_normal((SAMPLE["n"], SAMPLE["d_feat"]))
            .astype(np.float32),
            rng.integers(0, SAMPLE["n_classes"], SAMPLE["n"])
            .astype(np.int32))
