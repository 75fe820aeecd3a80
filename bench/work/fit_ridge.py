"""The ridge fit's stages on each coreset: the m rows gathered, the
weighted Gram (K3) and X^T (w y); the d x d solve is negligible."""


def stages(cell, req):
    d = int(cell.config["d"])
    gather, k3 = cell.work("gather"), cell.work("weighted_gram")
    out = []
    for m in req.ms:
        out += [("gather", gather.least_s(m, d)), ("weighted_gram", k3.least_s(m, d))]
    return out
