"""Host builders' seconds in set-up: the case from the seed, the port's
model and wells (meshes/, models/setup.py, models/wells.py), the
simulator's compiled model and, on the schedule path, lower_schedule."""


def read(ctx):
    return ctx.case_build_s
