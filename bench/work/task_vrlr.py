"""The stages of an Algorithm 2 build (``vrlr``), each with the kernel or
library call that serves it and its least time.

Scoring is once a request: the batched engine scores a sweep once, the
fused engine each build.  DIS is charged for each cell's m real rows:
round 1 m draws over T parties, round 2 m draws over n rows."""


def stages(cell, req):
    cfg = cell.config
    n, T = int(cfg["n"]), int(cfg["T"])
    s = max(int(w) for w in cfg["dims"]) + 1          # party T's block carries y
    k5, gram, k1 = (cell.work(w) for w in ("categorical", "weighted_gram", "leverage"))
    out = [("gram", gram.least_s(n, s, B=T)), ("leverage", k1.least_s(T, n, s))]
    for m in req.ms:
        out.append(("categorical", k5.least_s(m, T)))
        out.append(("categorical", k5.least_s(m, n, streams=T)))
    return out
