"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's:

* ``loss``: the largest relative gap of a step's loss (every loss the
  step reports) over the steps followed;
* ``logits``: the first step's largest absolute logit gap over the
  reference's largest absolute logit;
* ``state``: the worst parameter's gap between the norms of the
  optimizer's state after the first step (SGD's momentum buffer, Adam's
  first moment), over the reference's norm of that parameter or of the
  median parameter, whichever is larger;
* ``change``: the same for the change of each parameter after the last
  step followed, over the parameters whose first gradient in the
  reference is at least a thousandth of the median parameter's (a
  gradient nought to rounding, as a conv bias's before a batch norm,
  moves its parameter by round-off alone).
"""

import statistics

GRAD_FLOOR = 1e-3


def _norm_gap(prog, ref, names):
    scale = statistics.median(ref[n] for n in ref)
    each = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], scale, 1e-30)
            for n in names}
    at = max(each, key=each.get)
    return each[at], at


def gaps(prog, ref):
    """{number: (value, where)} for the readings of the program and of
    the reference (:func:`.follow.follow`'s dict)."""
    loss, at = 0.0, None
    for kind, values in ref["losses"].items():
        for i, r in enumerate(values):
            p = prog["losses"].get(kind, [float("nan")] * len(values))
            p = p[i] if i < len(p) else float("nan")
            g = abs(p - r) / max(abs(r), 1e-30)
            if not g <= loss:          # a NaN reading is the worst
                loss, at = g, f"{kind}[{i + 1}]"
    lr, lp = ref["logits"], prog.get("logits")
    if lp is None or tuple(lp.shape) != tuple(lr.shape):
        logits = float("inf")
    else:
        logits = float((lp.float() - lr).abs().max() / lr.abs().max())
    state = _norm_gap(prog["state"], ref["state"], list(ref["state"]))
    gscale = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= GRAD_FLOOR * gscale]
    change = _norm_gap(prog["change"], ref["change"], moved)
    return {"loss": (loss, at), "logits": (logits, "step 1"),
            "state": state, "change": change}
