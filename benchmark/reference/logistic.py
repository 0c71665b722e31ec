"""Plain L2-regularised logistic regression, shared by the references:

    f(w) = Σ_i [log(1 + exp(m_i)) − y_i m_i] + λ/2 ‖w‖²,   m_i = x_i · w + o_i,

evaluated in blocks of rows and minimized exactly by Newton's method with
step halving, for one dense problem or for many small ones at once (one per
entity). Imports torch alone; nothing of the program.

``precision`` is "f64" (every product and sum in float64) or "tf32" (every
product's inputs rounded to TF32's 10-bit mantissa, sums in float32: the
precision below float32 with TF32 off, for the controls).
"""

from __future__ import annotations

BLOCK = 1 << 15


def tf32(torch, t):
    """``t`` as float32 rounded to TF32: the low 13 mantissa bits rounded
    away (half away from zero)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def cast(torch, t, precision: str):
    return t.double() if precision == "f64" else tf32(torch, t)


def dtype_of(torch, precision: str):
    return torch.float64 if precision == "f64" else torch.float32


def objective(torch, x, y, lam: float, w, precision: str = "f64", order: int = 1,
              offsets=None):
    """(f, ∇f, ∇²f) at ``w``: the gradient from ``order`` 1 and the Hessian
    from ``order`` 2 on (None below)."""
    dt = dtype_of(torch, precision)
    n, d = x.shape
    dev = x.device
    wv = cast(torch, w.to(dev), precision)
    f = torch.zeros((), dtype=dt, device=dev)
    g = torch.zeros(d, dtype=dt, device=dev) if order >= 1 else None
    h = torch.zeros(d, d, dtype=dt, device=dev) if order >= 2 else None
    for lo in range(0, n, BLOCK):
        xb = cast(torch, x[lo:lo + BLOCK], precision)
        yb = y[lo:lo + BLOCK].to(dt)
        m = xb @ wv
        if offsets is not None:
            m = m + offsets[lo:lo + BLOCK].to(dt)
        f += (torch.nn.functional.softplus(m) - yb * m).sum()
        if order >= 1:
            p = torch.sigmoid(m)
            g += xb.T @ cast(torch, p - yb, precision)
        if order >= 2:
            h += xb.T @ cast(torch, xb * (p * (1.0 - p))[:, None], precision)
    w = w.to(dev, dt)
    f += 0.5 * lam * torch.dot(w, w)
    if order >= 1:
        g += lam * w
    if order >= 2:
        h += lam * torch.eye(d, dtype=dt, device=dev)
    return f, g, h


def newton(torch, x, y, lam: float, w0, precision: str = "f64", offsets=None,
           max_iter: int = 60):
    """The minimizer of f, by Newton steps halved until f does not rise,
    until a step moves no coefficient by more than 1e-13 of the largest
    (1e-6 in TF32) or f stops falling."""
    tol = 1e-13 if precision == "f64" else 1e-6
    w = w0.to(x.device, dtype_of(torch, precision)).clone()

    def at(v, order):
        return objective(torch, x, y, lam, v, precision, order, offsets)

    f, g, h = at(w, 2)
    for _ in range(max_iter):
        step = torch.linalg.solve(h, g)
        t = 1.0
        while True:
            trial = w - t * step
            f_trial = at(trial, 0)[0]
            if f_trial <= f or t < 1e-8:
                break
            t *= 0.5
        if not f_trial <= f:
            break
        small = float((t * step).abs().max()) <= tol * max(1.0, float(trial.abs().max()))
        w = trial
        if small:
            break
        f, g, h = at(w, 2)
    return w


def _entity_terms(torch, x, y, offsets, ent, v, num: int, order: int):
    """Per-entity f (without L2), gradient and Hessian of the rows' losses."""
    k = x.shape[1]
    f = torch.zeros(num, dtype=x.dtype, device=x.device)
    g = torch.zeros(num, k, dtype=x.dtype, device=x.device) if order >= 1 else None
    h = torch.zeros(num, k, k, dtype=x.dtype, device=x.device) if order >= 2 else None
    for lo in range(0, x.shape[0], BLOCK * 4):
        sl = slice(lo, lo + BLOCK * 4)
        xb, eb = x[sl], ent[sl]
        m = (xb * v[eb]).sum(dim=1) + offsets[sl]
        f.index_add_(0, eb, torch.nn.functional.softplus(m) - y[sl] * m)
        if order >= 1:
            p = torch.sigmoid(m)
            g.index_add_(0, eb, (p - y[sl])[:, None] * xb)
        if order >= 2:
            h.index_add_(0, eb, (p * (1.0 - p))[:, None, None] * xb[:, :, None] * xb[:, None, :])
    return f, g, h


def newton_entities(torch, x, y, offsets, ent, num: int, lam: float, max_iter: int = 60):
    """Each entity's minimizer, in float64: rows ``x`` [m, k] with labels,
    offsets and entity ``ent`` [m]; ``num`` entities, each with its own
    L2 term. Newton steps per entity, each halved until its f does not
    rise; all stop when no step moves a coefficient by more than 1e-13 of
    the largest."""
    k = x.shape[1]
    eye = torch.eye(k, dtype=x.dtype, device=x.device)
    v = torch.zeros(num, k, dtype=x.dtype, device=x.device)

    def reg(u):
        return 0.5 * lam * (u * u).sum(dim=1)

    for _ in range(max_iter):
        f, g, h = _entity_terms(torch, x, y, offsets, ent, v, num, 2)
        f, g, h = f + reg(v), g + lam * v, h + lam * eye
        step = torch.linalg.solve(h, g.unsqueeze(-1)).squeeze(-1)
        t = torch.ones(num, dtype=x.dtype, device=x.device)
        done = torch.zeros(num, dtype=torch.bool, device=x.device)
        new = v.clone()
        for _ in range(40):
            trial = v - t[:, None] * step
            f_trial = _entity_terms(torch, x, y, offsets, ent, trial, num, 0)[0] + reg(trial)
            ok = (f_trial <= f) & ~done
            new[ok] = trial[ok]
            done |= ok
            if bool(done.all()):
                break
            t = torch.where(done, t, 0.5 * t)
        moved = float(((new - v).abs().max()))
        v = new
        if moved <= 1e-13 * max(1.0, float(v.abs().max())):
            break
    return v
