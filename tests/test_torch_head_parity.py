"""Deep converter-fidelity test: a torch model assembled from standard torch
modules with the REFERENCE's architecture (pre-LN MHA transformer +
permutation symmetriser, reference: src/grappa/models/perm_equiv_transformer
.py and network_utils.py) must produce the same outputs as our flax head
when loaded from the exported state_dict. This validates end-to-end numeric
fidelity of the checkpoint contract beyond naming/shape checks — the
grappa-1.2 round-trip oracle minus the (dgl-dependent) GNN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.models.heads import TupleHead, PERMUTATIONS, POSITIONAL_ENCODINGS


class TorchFF(torch.nn.Module):
    """Reference FeedForwardLayer: pre-LN, one hidden layer, optional skip."""

    def __init__(self, in_f, hidden, out_f, skip):
        super().__init__()
        self.norm1 = torch.nn.LayerNorm(in_f)
        self.linear1 = torch.nn.Linear(in_f, hidden)
        self.linear2 = torch.nn.Linear(hidden, out_f)
        self.skip = skip

    def forward(self, x):
        h = self.norm1(x)
        out = self.linear2(torch.nn.functional.elu(self.linear1(h)))
        return out + h if self.skip else out


class TorchBlock(torch.nn.Module):
    """Reference DottedAttWithMLP."""

    def __init__(self, f, heads):
        super().__init__()
        self.norm1 = torch.nn.LayerNorm(f)
        self.attn = torch.nn.MultiheadAttention(f, heads)
        self.ff = TorchFF(f, f, f, skip=True)

    def forward(self, x):      # x: (S, T, F) seq-first
        x = self.norm1(x)
        a, _ = self.attn(x, x, x, need_weights=False)
        return self.ff(a + x)


class TorchHead(torch.nn.Module):
    """Reference rep_projector + GrappaTransformer + Symmetriser."""

    def __init__(self, rep, width, depth, heads, sym_depth, sym_width,
                 arity, out_f, perms, pos_enc):
        super().__init__()
        pos_dim = 0 if pos_enc is None else len(pos_enc[0])
        self.rep_projector = torch.nn.Linear(rep, width - pos_dim)
        self.pos_enc = (None if pos_enc is None
                        else torch.tensor(pos_enc, dtype=torch.float32))
        self.blocks = torch.nn.ModuleList(
            [TorchBlock(width, heads) for _ in range(depth)])
        self.perms = torch.tensor(perms, dtype=torch.long)
        layers = []
        last = sym_depth - 1
        layers.append(TorchFF(arity * width, sym_width if sym_depth > 1
                              else out_f, sym_width, skip=False))
        for i in range(1, sym_depth):
            layers.append(TorchFF(sym_width,
                                  sym_width if i != last else out_f,
                                  sym_width, skip=(i != last)))
        self.sym = torch.nn.ModuleList(layers)

    def forward(self, h, idxs):
        x = torch.nn.functional.elu(self.rep_projector(h))[idxs]  # (T, S, F')
        if self.pos_enc is not None:
            pos = self.pos_enc[None].expand(x.shape[0], -1, -1)
            x = torch.cat([x, pos], dim=-1)
        x = x.transpose(0, 1)            # (S, T, F) seq-first like torch MHA
        for blk in self.blocks:
            x = blk(x)
        x = x.transpose(0, 1)            # (T, S, F)
        outs = 0
        for p in self.perms:
            flat = x[:, p, :].reshape(x.shape[0], -1)
            out = flat
            for layer in self.sym:
                out = layer(out)
            outs = outs + out
        return outs


@pytest.mark.parametrize('term,out_f', [('n2', 2), ('n3', 2), ('n4', 12),
                                        ('n4_improper', 6)])
def test_head_forward_matches_torch(term, out_f):
    rep, width, depth, heads, sym_depth, sym_width = 32, 64, 2, 4, 2, 48
    arity = {'n2': 2, 'n3': 3, 'n4': 4, 'n4_improper': 4}[term]
    perms = PERMUTATIONS[term]
    pos_enc = POSITIONAL_ENCODINGS[term]
    proj = width - (0 if pos_enc is None else len(pos_enc[0]))

    rng = np.random.default_rng(0)
    n_atoms, t = 20, 9
    h_in = rng.normal(size=(n_atoms, rep)).astype(np.float32)
    idxs = np.stack([rng.choice(n_atoms, arity, replace=False)
                     for _ in range(t)]).astype(np.int32)

    flax_head = TupleHead(
        arity=arity, proj_feats=proj, transformer_layers=depth,
        n_heads=heads, hidden_feats=width, symmetriser_layers=sym_depth,
        symmetriser_feats=sym_width, out_feats=out_f, permutations=perms,
        positional_encoding=pos_enc)
    variables = flax_head.init(jax.random.key(0), jnp.asarray(h_in),
                               jnp.asarray(idxs))
    flax_out = flax_head.apply(variables, jnp.asarray(h_in),
                               jnp.asarray(idxs))

    torch_head = TorchHead(rep, width, depth, heads, sym_depth, sym_width,
                           arity, out_f, perms, pos_enc)
    # convert flax params -> torch modules
    p = variables['params']

    def set_linear(mod, tree):
        mod.weight.data = torch.tensor(np.asarray(tree['kernel']).T)
        mod.bias.data = torch.tensor(np.asarray(tree['bias']))

    def set_norm(mod, tree):
        mod.weight.data = torch.tensor(np.asarray(tree['scale']))
        mod.bias.data = torch.tensor(np.asarray(tree['bias']))

    set_linear(torch_head.rep_projector, p['rep_projector'])
    for i, blk in enumerate(torch_head.blocks):
        tr = p[f'transformer_{i}']
        set_norm(blk.norm1, tr['norm1'])
        blk.attn.in_proj_weight.data = torch.tensor(
            np.asarray(tr['attn']['in_proj']['kernel']).T)
        blk.attn.in_proj_bias.data = torch.tensor(
            np.asarray(tr['attn']['in_proj']['bias']))
        set_linear(blk.attn.out_proj, tr['attn']['out_proj'])
        set_norm(blk.ff.norm1, tr['ff']['norm'])
        set_linear(blk.ff.linear1, tr['ff']['linear1'])
        set_linear(blk.ff.linear2, tr['ff']['linear2'])
    for i, layer in enumerate(torch_head.sym):
        tree = p['symmetriser'][f'mlp_{i}']
        set_norm(layer.norm1, tree['norm'])
        set_linear(layer.linear1, tree['linear1'])
        set_linear(layer.linear2, tree['linear2'])

    with torch.no_grad():
        torch_out = torch_head(torch.tensor(h_in),
                               torch.tensor(idxs, dtype=torch.long)).numpy()
    np.testing.assert_allclose(np.asarray(flax_out), torch_out,
                               rtol=2e-4, atol=2e-5)
