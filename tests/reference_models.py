"""Plain NumPy references of the four models' forward math.

Independent of the package's layer code: each layer is written from the
reference formulas (DGL SAGEConv 'mean' / GraphConv norm='both' / GATConv
per legion_{graphsage,gcn,gat}.py) over a plain (src, dst) edge list, with
per-destination reductions done by ``np.add.at`` and arithmetic in float64.
Nothing here relies on the sampler's fanout-major edge layout, so the same
functions check the lane-aligned last hop and the deduped hops alike.

Edges whose src or dst is -1 are padding and contribute nothing. Used by
tests/test_models.py and by chip_smoke.py's parity phase.
"""

import numpy as np


def _valid_edges(src, dst):
    src, dst = np.asarray(src), np.asarray(dst)
    keep = (src >= 0) & (dst >= 0)
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


def _seg_sum(vals, seg, n):
    out = np.zeros((n,) + vals.shape[1:], np.float64)
    np.add.at(out, seg, vals)
    return out


def np_sage_layer(p, h_src, src, dst, num_dst):
    """h'_v = W_self h_v + b + W_neigh mean_{(u->v)} h_u (zero if none)."""
    src, dst = _valid_edges(src, dst)
    h_src = np.asarray(h_src, np.float64)
    cnt = np.bincount(dst, minlength=num_dst)[:, None]
    h_n = _seg_sum(h_src[src], dst, num_dst) / np.maximum(cnt, 1)
    return (h_src[:num_dst] @ np.asarray(p["w_self"], np.float64)
            + h_n @ np.asarray(p["w_neigh"], np.float64)
            + np.asarray(p["b"], np.float64))


def np_gcn_layer(p, h_src, src, dst, num_dst):
    """h'_v = b + d_in(v)^-1/2 sum_{(u->v)} d_out(u)^-1/2 (h_u W), with
    block-local degrees; zero in-degree vertices get only the bias."""
    src, dst = _valid_edges(src, dst)
    out_deg = np.bincount(src, minlength=h_src.shape[0])
    in_deg = np.bincount(dst, minlength=num_dst)
    hw = np.asarray(h_src, np.float64) @ np.asarray(p["w"], np.float64)
    msg = hw[src] / np.sqrt(out_deg[src])[:, None]
    out = _seg_sum(msg, dst, num_dst)
    out /= np.sqrt(np.maximum(in_deg, 1))[:, None]
    return out + np.asarray(p["b"], np.float64)


def np_gat_layer(p, h_src, src, dst, num_dst, slope=0.2):
    """Multi-head GATConv: [num_dst, H, d_out]; softmax over each
    destination's in-edges, bias only for vertices without edges."""
    src, dst = _valid_edges(src, dst)
    H, d_out = np.asarray(p["attn_l"]).shape
    h_src = np.asarray(h_src, np.float64)
    z = (h_src @ np.asarray(p["w"], np.float64).reshape(h_src.shape[1], -1)
         ).reshape(-1, H, d_out)
    el = (z * np.asarray(p["attn_l"], np.float64)).sum(-1)
    er = (z * np.asarray(p["attn_r"], np.float64)).sum(-1)
    e = el[src] + er[dst]
    e = np.where(e > 0, e, slope * e)                        # [E, H]
    m = np.full((num_dst, H), -np.inf)
    np.maximum.at(m, dst, e)
    a = np.exp(e - m[dst])
    a /= _seg_sum(a, dst, num_dst)[dst]
    out = _seg_sum(z[src] * a[:, :, None], dst, num_dst)
    return out + np.asarray(p["b"], np.float64)


def _stack(layer, params, feats, edge_src, edge_dst, S, between):
    """Layer i aggregates hop k = L-1-i over node positions [0, S[k+1])."""
    L = len(edge_src)
    h = np.asarray(feats, np.float64)
    for i in range(L):
        k = L - 1 - i
        h = layer(params["layers"][i], h[:S[k + 1]],
                  np.asarray(edge_src[k]), np.asarray(edge_dst[k]), S[k])
        h = between(h, last=i == L - 1)
    return h


def _relu_between(h, last):
    return h if last else np.maximum(h, 0)


def sage_forward(params, feats, edge_src, edge_dst, S, batch_size):
    """GraphSAGE logits (also the LinkPredSAGE encoder: same stack, hidden
    width at the last layer)."""
    return _stack(np_sage_layer, params, feats, edge_src, edge_dst, S,
                  _relu_between)[:batch_size]


def gcn_forward(params, feats, edge_src, edge_dst, S, batch_size):
    return _stack(np_gcn_layer, params, feats, edge_src, edge_dst, S,
                  _relu_between)[:batch_size]


def gat_forward(params, feats, edge_src, edge_dst, S, batch_size):
    """Mid layers flatten heads + ELU; the last layer means its heads."""
    def between(out, last):
        if last:
            return out.mean(1)
        out = out.reshape(out.shape[0], -1)
        return np.where(out > 0, out, np.expm1(np.minimum(out, 0)))
    return _stack(np_gat_layer, params, feats, edge_src, edge_dst, S,
                  between)[:batch_size]


FORWARD = {"graphsage": sage_forward, "lp_sage": sage_forward,
           "gcn": gcn_forward, "gat": gat_forward}


def to_numpy(tree):
    """Device params -> nested dict/list of NumPy arrays."""
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)
