"""Training on one card or over a device mesh: the mesh, differentiable
collectives and the allreduce probe, ring/zigzag and Ulysses attention,
the train step and checkpoints."""
