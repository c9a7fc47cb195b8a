"""Shared harness of the port's training parity tests (not a test module).

One seeded batch goes through ``jax.value_and_grad(loss_fn)`` and the
JAX package's ``make_train_step``, and through the port's
``value_and_grad`` and ``make_train_step``, on the same f32 parameters.
The parameters are the port's draws (``init_params(..., masters=True)``:
lecun fan-in per matrix) carried into the JAX package's tree
(:func:`reference_tree`).  The JAX package's own draws take the fan-in
of a stacked ``scan`` leaf from its repeat axis, which grows hidden
states to about 1e3; its f32 gradients of those draws then sit up to 5%
of a leaf's largest value from a float64 evaluation (recurrentgemma-9b-
smoke, measured), so two f32 evaluations cannot be held to each other
there.  On the port's draws the two packages agree to about 4e-6.

Tolerances (f32 smoke configs):
  * loss: 1e-5 relative;
  * gradients: 1e-4 of each leaf's largest |gradient| plus 1e-7.  The
    floor covers a gradient that is 0 in exact arithmetic: llama4's
    top-1 router (its renormalised gate is 1 whatever the router says)
    gets f32 rounding noise of about 1e-9 in both packages;
  * the parameters after one AdamW step: 1e-4 of each leaf's largest
    |value|, except where the JAX package's gradient lies within the
    gradient tolerance of 0.  The first AdamW step moves an entry by
    lr * g / (|g| + eps), so where gradients that agree to that
    tolerance do not fix the sign of g, two evaluations may move it by
    up to 2 lr apart;
  * ``lr`` exactly, ``grad_norm`` 1e-5 relative.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import model as JM
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import init_train_state as j_init_train_state
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.models.common import ParamTree, children, named_leaves
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                         value_and_grad)
from repro_torch.train.trainer import to_device

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
PARAM_RTOL = 1e-4
NORM_RTOL = 1e-5
# seq_len 128: the JAX package's Pallas forward takes whole 128-row
# blocks; prefix tokens count toward it
SEQ_LEN = 128
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
# the dense configs: granite-8b-smoke; gemma3-1b-smoke with local layers,
# a remainder layer and tied embeddings; internvl2-2b-smoke with prefix
# embeddings and a loss mask; each under both attention routes
DENSE_CASES = [(arch, impl) for arch in ("granite-8b-smoke",
                                         "gemma3-1b-smoke",
                                         "internvl2-2b-smoke")
               for impl in ("xla", "pallas")]
# the Mamba, RG-LRU, MoE and MLA families: the route matters only where
# a config has GQA layers (recurrentgemma's local layers, llama4's
# attention); falcon-mamba has none and deepseek-v2's MLA computes its
# attention plainly in both packages, so those two run one route
FAMILY_CASES = [("falcon-mamba-7b-smoke", "xla"),
                ("recurrentgemma-9b-smoke", "xla"),
                ("recurrentgemma-9b-smoke", "pallas"),
                ("llama4-scout-17b-a16e-smoke", "xla"),
                ("llama4-scout-17b-a16e-smoke", "pallas"),
                ("deepseek-v2-236b-smoke", "xla")]


def flat_reference(tree) -> dict:
    """The JAX package's tree as {port path: numpy array}: keys joined
    with "/", the stacked ``layers/scan`` leaves split per repeat."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        arr = np.asarray(leaf)
        if parts[:2] == ["layers", "scan"]:
            for r in range(arr.shape[0]):
                out["/".join(parts[:2] + [str(r)] + parts[2:])] = arr[r]
        else:
            out["/".join(parts)] = arr
    return out


def reference_tree(params) -> dict:
    """The port's parameters as the JAX package's tree of numpy arrays:
    the per-repeat ``layers/scan`` trees stacked on a leading axis."""
    def plain(node):
        if isinstance(node, torch.Tensor):
            return node.detach().numpy().copy()
        kids = children(node)
        if isinstance(node, (dict, ParamTree)):
            return {k: plain(v) for k, v in kids}
        return [plain(v) for _, v in kids]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    tree = plain(params)
    if "scan" in tree["layers"]:
        tree["layers"]["scan"] = stack(tree["layers"]["scan"])
    return tree


def setup(name: str, impl: str, step: int = 3):
    jcfg = replace(j_get_config(name), attn_impl=impl)
    tcfg = replace(get_config(name), attn_impl=impl)
    tp = init_params(tcfg, 0, CPU, masters=True)
    jp = jax.tree.map(jnp.asarray, reference_tree(tp))
    data = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ_LEN,
                       global_batch=2, n_prefix_tokens=jcfg.n_prefix_tokens,
                       d_model=jcfg.d_model)
    batch = j_make_batch(data, step)
    return jcfg, tcfg, jp, tp, batch


def _grad_tol(ref: np.ndarray) -> float:
    return GRAD_RTOL * float(np.abs(ref).max()) + GRAD_ATOL


def check_loss_and_grads(name: str, impl: str) -> None:
    jcfg, tcfg, jp, tp, batch = setup(name, impl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(JM.loss_fn),
                                    static_argnums=2)(jp, jb, jcfg)
    loss, grads = value_and_grad(tp, to_device(batch, CPU), tcfg)
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss)), (float(loss), float(want_loss))
    want = flat_reference(want_grads)
    got = named_leaves(grads)
    assert sorted(k for k, _ in got) == sorted(want)
    for key, g in got:
        err = float(np.abs(g.numpy() - want[key]).max())
        assert err <= _grad_tol(want[key]), (key, err)


def check_train_step(name: str, impl: str) -> None:
    jcfg, tcfg, jp, tp, batch = setup(name, impl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, want_grads = jax.jit(jax.value_and_grad(JM.loss_fn),
                            static_argnums=2)(jp, jb, jcfg)
    j_step = jax.jit(j_make_train_step(jcfg, JOptConfig(**OPT)))
    want_params, want_state, want_m = j_step(
        jp, j_init_train_state(jcfg, jp), jb)
    step = make_train_step(tcfg, OptConfig(**OPT))
    params, state, metrics = step(tp, init_train_state(tcfg, tp),
                                  to_device(batch, CPU))
    assert int(state["step"]) == int(want_state["step"]) == 1
    assert float(metrics["lr"]) == float(want_m["lr"])
    assert abs(float(metrics["loss"]) - float(want_m["loss"])) <= \
        LOSS_RTOL * abs(float(want_m["loss"]))
    assert abs(float(metrics["grad_norm"]) - float(want_m["grad_norm"])) \
        <= NORM_RTOL * float(want_m["grad_norm"])
    lr = float(want_m["lr"])
    want = flat_reference(want_params)
    grads = flat_reference(want_grads)
    for key, p in named_leaves(params):
        assert p.requires_grad, key
        p = p.detach().numpy()
        diff = np.abs(p - want[key])
        tol = PARAM_RTOL * float(np.abs(want[key]).max())
        unresolved = np.abs(grads[key]) <= _grad_tol(grads[key])
        assert (diff[~unresolved] <= tol).all(), (key, diff.max(), tol)
        assert (diff[unresolved] <= tol + 2 * lr).all(), (key, diff.max())
