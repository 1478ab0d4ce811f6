"""The training cells' inputs and their check against the reference.

The benchmark makes every input from the seed and hands the same to the
program and to the reference: the real batches (uint8, every row
different), and each step's latents and path-length noise (through the
train step's ``draws=``).  Set-up drives the program's own step object
through three steps of the three cadence variants, plain, R1 + path and
path, and reads from it:

* each step's losses;
* Adam's first moments after steps 0 and 1.  beta1 is 0 under the lazy
  scaling, so each is the last gradient the optimizer got: after step 0 the
  D and G losses' gradients, after step 1 the R1 penalty's gradient of D
  and the path-length penalty's gradient of G, each with its weight;
* each leaf's change over the three steps, for G, D and the EMA of G.

After the window the reference runs the same three steps from weights made
again from the seed, and ``numbers`` reads, each leaf measured against the
larger of its own reference value and the median leaf's:

* ``loss_gap``, ``r1_gap``, ``path_gap``: the worst gap of the D and G
  losses, of the R1 penalty and of the path-length penalty;
* ``grad_gap_g`` / ``grad_gap_d``: the worst leaf's gap of norms of the
  first gradient, and ``reg_grad_gap_g`` / ``reg_grad_gap_d`` of the
  path-length and R1 gradients: these see a gradient's scale, so a loss or
  a penalty weighted wrongly;
* ``grad_shape_med``: the median leaf of G and D of the same gap with each
  net's overall scale divided out (where D scores the fakes as real, G's
  loss sits in the tail of its softplus and a rounding of the logits scales
  all of G's gradient at once);
* ``grad_dir_med_d``: the median leaf of D of the sine of the angle between
  the program's first gradient and the reference's, element by element.  A
  gap of norms averages rounding out over a leaf's elements; the angle
  keeps it, so it tells one precision from the next;
* ``change_gap``: the worst leaf's gap of norms of the change over the
  three steps, in G, D and the EMA.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the change and of the angles, since rounding alone moves or
points them.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.harness import compare, weights
from portbench.harness.runner import derive
from portbench.reference import train as ref_train

# (do_d_reg, do_g_reg) of the three checked steps
CHECK_VARIANTS = ((False, False), (True, True), (False, True))


def terms(r1: bool, path: bool) -> tuple:
    return ("d",) + (("r1",) if r1 else ()) + ("g",) + (
        ("path",) if path else ())


def real_pool(seed: int, batches: int, batch: int, size: int) -> np.ndarray:
    """[batches, batch, size, size, 3] uint8, every row different."""
    rng = np.random.default_rng(derive(seed, "real"))
    return rng.integers(0, 256, (batches, batch, size, size, 3),
                        dtype=np.uint8)


def step_draws(m: dict, seed: int, k: int, batch: int, path_batch: int,
               path: bool, device) -> dict:
    """Step ``k``'s latents (and path noise) on the device."""
    gen = torch.Generator(device).manual_seed(derive(seed, "draws", k))
    t, sd, pd, size = m["n_tokens"], m["style_dim"], m["param_dim"], m["size"]

    def codes(n):
        return (torch.randn(n, t, sd, generator=gen, device=device),
                torch.randn(n, t, pd, generator=gen, device=device))

    out = {"d": codes(batch), "g": codes(batch)}
    if path:
        noise = torch.randn(path_batch, size, size, 3, generator=gen,
                            device=device) / size
        out["path"] = (*codes(path_batch), noise)
    return out


def moments(nets) -> dict:
    """{net: {leaf: Adam's first moment, float32 on the host}} of
    ``nets`` ((net, module, torch optimizer) triples); ``None`` where the
    optimizer never got a gradient for the leaf."""
    out = {}
    for net, mod, opt in nets:
        out[net] = {}
        for n, p in mod.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[net][n] = None if m is None else m.detach().to(
                "cpu", torch.float32, copy=True)
    return out


def norms(tensors: dict) -> dict:
    """{leaf: ‖tensor‖}, 0 for a leaf without one."""
    return {n: 0.0 if t is None else float(t.norm())
            for n, t in tensors.items()}


def change_norms(nets: dict, initial: dict) -> dict:
    """{net: {leaf: ‖p - p0‖}} against the initial state dicts."""
    out = {}
    for key, net in nets.items():
        p0 = initial["d" if key == "d" else "g"]
        out[key] = {n: float((p.detach().float() - p0[n]).norm())
                    for n, p in net.named_parameters()}
    return out


def initial_weights(m: dict, seed: int, device) -> dict:
    g, d = weights.make(m, seed, device)
    return {"g": weights.state_dict(g), "d": weights.state_dict(d)}


def reference_readings(config: dict, seed: int, reals, device,
                       quant=None, rows=None) -> dict:
    """The readings of the reference's first three steps (``quant`` or
    ``rows`` make it a control or a planted fault instead)."""
    m, tc = config["model"], config["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g, d = weights.make(m, seed, device)
    if quant is not None:
        g.set_quant(quant)
        d.set_quant(quant)
    st = ref_train.init(g, d, tc)
    if quant is not None:
        st.g_ema.set_quant(quant)
    batch = tc["batch_size"]
    path_batch = max(1, batch // tc["path_batch_shrink"])
    out = {"losses": [], "grads": []}
    for k, (r1, path) in enumerate(CHECK_VARIANTS):
        real = torch.as_tensor(reals[k], device=device)
        dr = step_draws(m, seed, k, batch, path_batch, path, device)
        got = ref_train.step(st, real, dr, tc, r1, path, rows=rows)
        out["losses"].append({t: float(got[t]) for t in terms(r1, path)})
        if k < 2:
            out["grads"].append({
                net: {n: mom.clone() for (n, _), mom in
                      zip(mod.named_parameters(), opt.m)}
                for net, mod, opt in (("g", g, st.opt_g), ("d", d, st.opt_d))})
    init = initial_weights(m, seed, device)
    out["change"] = change_norms({"g": g, "d": d, "g_ema": st.g_ema}, init)
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """Every number the check can compare: {name: (value, where)}."""
    out = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"],
                                        ("d", "g")),
           "r1_gap": compare.loss_gap(prog["losses"], ref["losses"],
                                      ("r1",)),
           "path_gap": compare.loss_gap(prog["losses"], ref["losses"],
                                        ("path",))}
    pn = [{net: norms(t) for net, t in step.items()} for step in prog["grads"]]
    rn = [{net: norms(t) for net, t in step.items()} for step in ref["grads"]]
    for net in ("g", "d"):
        gap, where = compare.norm_gap(pn[0][net], rn[0][net])
        out[f"grad_gap_{net}"] = (gap, f"{net}.{where}")
    for net, what in (("g", "path length"), ("d", "R1")):
        gap, where = compare.norm_gap(pn[1][net], rn[1][net])
        out[f"reg_grad_gap_{net}"] = (gap, f"{net}.{where} ({what})")
    both = []
    for net in ("g", "d"):
        both += compare.leaf_gaps(compare.rescaled(pn[0][net], rn[0][net]),
                                  rn[0][net])
    out["grad_shape_med"] = (statistics.median(both),
                             f"median of {len(both)} leaves of G and D")
    sines = compare.leaf_sines(prog["grads"][0]["d"], ref["grads"][0]["d"],
                               skip=compare.quiet_leaves(rn[0]["d"]))
    out["grad_dir_med_d"] = (statistics.median(sines.values()),
                             f"median of {len(sines)} leaves of D")
    worst, at = 0.0, ""
    for net in ("g", "d", "g_ema"):
        quiet = compare.quiet_leaves(rn[0]["d" if net == "d" else "g"])
        gap, where = compare.norm_gap(prog["change"][net],
                                      ref["change"][net], skip=quiet)
        if not gap <= worst:
            worst, at = gap, f"{net}.{where}"
    out["change_gap"] = (worst, at)
    return out


def judge(run, prog: dict, ref: dict) -> None:
    """Compare the numbers the cell sets a limit for; note the others."""
    run.record(numbers(prog, ref))
