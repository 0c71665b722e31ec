"""Plain reference of kind ``glm_path``: each λ of the program's last path
solved exactly in float64 (``reference/logistic.py``) from the benchmark's
own inputs. Imports torch alone; nothing of the program.

Numbers, one set per λ:

- ``loss_gap``: the value the program's solver reported at its answer
  against f at that answer, relative;
- ``grad0_gap``: the first gradient norm the solver saw against ‖∇f‖ at the
  point that λ started from (zero, then the previous λ's answer), relative;
- ``coef_gap``: the answer against the exact minimizer, by the worst
  coefficient over the largest one.

``control_answers`` puts this reference in the program's place in TF32.
"""

from __future__ import annotations

from reference import logistic


def check(torch, config: dict, traffic: dict, inputs: dict, answers: list) -> list:
    x, y = inputs["x"], inputs["y"]
    out = []
    w_ref = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for a in answers:
        lam = float(a["lambda"])
        w_ref = logistic.newton(torch, x, y, lam, w_ref)
        w = a["w"].to(x.device, torch.float64)
        f_w = float(logistic.objective(torch, x, y, lam, w, order=0)[0])
        g0 = float(torch.linalg.vector_norm(logistic.objective(torch, x, y, lam, a["start"])[1]))
        out.append({
            "loss_gap": abs(a["value"] - f_w) / abs(f_w),
            "grad0_gap": abs(a["grad0"] - g0) / g0,
            "coef_gap": float((w - w_ref).abs().max() / w_ref.abs().max()),
        })
    return out


def control_answers(torch, config: dict, traffic: dict, inputs: dict) -> list:
    """The reference in the program's place, in TF32: answers in the form
    ``traffic/glm_path.answers`` gives the program's."""
    x, y = inputs["x"], inputs["y"]
    out, start = [], torch.zeros(x.shape[1], device=x.device)
    for lam in sorted(config["regularization_weights"]):
        lam = float(lam)
        w = logistic.newton(torch, x, y, lam, start, "tf32")
        f = logistic.objective(torch, x, y, lam, w, "tf32", order=0)[0]
        g0 = logistic.objective(torch, x, y, lam, start, "tf32")[1]
        out.append({"lambda": lam, "w": w.double().cpu(), "value": float(f),
                    "grad0": float(torch.linalg.vector_norm(g0)),
                    "start": start.double().cpu()})
        start = w
    return out
