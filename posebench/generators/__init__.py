"""One module per traffic generator; a mix in ``traffic/<mix>.json`` names
its generator, whose ``Traffic(cell)`` drives the cell."""
