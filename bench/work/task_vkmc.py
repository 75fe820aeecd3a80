"""The stages of an Algorithm 3 build (``vkmc``), each with its kernel
and least time: per party k k-means++ picks over n rows (each after the
first with a distance update over the party's block), ``local_iters``
Lloyd sweeps and one scoring sweep of K2 over the (T, n, s) stack; then
DIS over each cell's m real rows."""


def stages(cell, req):
    cfg = cell.config
    n, T = int(cfg["n"]), int(cfg["T"])
    s = max(int(w) for w in cfg["dims"])
    tp = cfg["task_params"]
    k, iters = int(tp["k"]), int(tp["local_iters"])
    k5, k2, gather = (cell.work(w) for w in ("categorical", "kmeans_assign_update", "gather"))
    out = []
    for _ in range(T):
        out += [("categorical", k5.least_s(1, n))] * k
        # the distance update after a pick reads the block once: half a gather's bytes
        out += [("distance", gather.least_s(n, s) / 2)] * (k - 1)
    out += [("kmeans_assign_update", k2.least_s(T, n, k, s, True, 0))] * (iters + 1)
    for m in req.ms:
        out.append(("categorical", k5.least_s(m, T)))
        out.append(("categorical", k5.least_s(m, n, streams=T)))
    return out
