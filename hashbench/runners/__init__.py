"""A runner a kind of cell: `harness.run_cell` hands a cell whose
configuration names `"runner": "<name>"` to `runners/<name>.py`'s
`run(cell, seed, seconds, trace, device, t_start, min_calls)`, which
returns the result line's object (the keys of `harness.run_cell`'s)."""
