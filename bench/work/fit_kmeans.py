"""The k-means fit's stages on each coreset: the m rows gathered, k
k-means++ picks over m rows (each after the first with a distance
update), ``iters`` weighted Lloyd sweeps (K2) and the cost (K4)."""


def stages(cell, req):
    cfg = cell.config
    d = int(cfg["d"])
    f = cfg["fit"]
    k, iters = int(f["k"]), int(f["iters"])
    k5, k2, k4, gather = (cell.work(w) for w in
                          ("categorical", "kmeans_assign_update", "kmeans_assign", "gather"))
    out = []
    for m in req.ms:
        out.append(("gather", gather.least_s(m, d)))
        out += [("categorical", k5.least_s(1, m))] * k
        out += [("distance", gather.least_s(m, d) / 2)] * (k - 1)
        out += [("kmeans_assign_update", k2.least_s(1, m, k, d, False, m))] * iters
        out.append(("kmeans_assign", k4.least_s(m, k, d, m)))
    return out
