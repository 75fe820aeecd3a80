# Launchers of the port: train.py (the training launcher).  The reference's
# mesh, dryrun, hillclimb, hlo and roofline wait for ROADMAP queue 1, items
# 18.7 and 18.8.
