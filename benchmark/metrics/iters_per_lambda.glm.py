"""``iters_per_lambda.glm``: solver iterations over the λ solves of the traced
paths (the sum of ``SolverResult.iterations``, from ``train_glm``'s
``on_solve``). A count of the program's own; moves ``glm_lambda_s``."""


def read(ctx):
    counts = ctx["counts"]
    return counts["iterations"] / counts["solves"] if counts.get("solves") else None
