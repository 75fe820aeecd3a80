# Launchers of the port: train.py (the training launcher and its production
# plan), mesh.py (the production meshes over torch.distributed),
# inputs.py (meta-device stand-ins of every model input), dryrun.py (every
# arch x shape run once on the meta device: FLOPs, bytes, per-device memory
# and the roofline terms), hillclimb.py (the variant table over dryrun),
# trace.py (the op census and collectives of a torch.profiler trace, and
# the aten-op counters of a meta run; the counterpart of the reference's
# hlo.py) and roofline.py (the three-term model at H100 constants).
