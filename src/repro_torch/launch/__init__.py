# Launchers of the port: train.py (the training launcher and its production
# plan).  The reference's mesh, dryrun, hillclimb, hlo and roofline wait for
# ROADMAP queue 1, item 18.8.
