"""The program's own state at chosen points inside its sweeps, for the
checks of a later block or row range (`bench_port.ref.compare`).

`SweepStates` installs stand-ins around the sweep's steps, as
`trace.Launches` does around the kernels, and keeps a host copy of the
MSA the program holds where a chosen block starts:

  * the tail's Jacobi sweeps (`BatchedRealigner`, block > 1): the MSA
    on the host at the start of block `jacobi[block_rows]` of the sweep,
    `at[(block_rows, block)]`;
  * its serial sweep (block 1): the sweep is first run to the end of its
    first `serial_start` rows by its own `rows` hook, the state kept as
    `at[("serial", serial_start)]`, and the sweep then runs whole from
    the same input;
  * the resident engine (`DeviceResidentRealigner`): the MSA on the card
    at the start of each block in `resident_blocks` of each sweep in
    `resident_sweeps` (counted from 1 in the run), `at[(sweep, block)]`,
    and at the sweep's end, `at[(sweep, "end")]`. A sweep that is redone
    keeps its last try's states.

Used after the window only, in a run of the same entry on the same
input; the caller compares that run's outputs with the window's."""
from __future__ import annotations

import numpy as np


class SweepStates:
    def __init__(self, jacobi: dict | None = None,
                 serial_start: int | None = None, resident_sweeps=(),
                 resident_blocks=()):
        self.jacobi = dict(jacobi or {})
        self.serial_start = serial_start
        self.resident_sweeps = set(resident_sweeps)
        self.resident_blocks = set(resident_blocks)
        self.at: dict = {}
        self._block = 0
        self._sweep = 0
        self._saved = []

    def __enter__(self):
        from repeatresolver_tpu_torch.models import realigner_device as rd
        from repeatresolver_tpu_torch.models.realigner import \
            BatchedRealigner as BR
        D = rd.DeviceResidentRealigner
        sweep0, block0 = BR._sweep, BR._realign_block
        rsweep0, try0, exact0 = D.sweep, D._try_sweep, D._exact_block
        step0 = rd.block_step
        keep = self

        def _sweep(eng, rows=None):
            keep._block = 0
            if eng.block_rows == 1 and rows is None \
                    and keep.serial_start is not None:
                msa, counts = eng.msa.copy(), eng.counts.copy()
                sweep0(eng, keep.serial_start)
                keep.at[("serial", keep.serial_start)] = eng.msa.copy()
                eng.msa, eng.counts = msa, counts
            return sweep0(eng, rows)

        def _realign_block(eng, rows):
            if keep.jacobi.get(eng.block_rows) == keep._block:
                keep.at[(eng.block_rows, keep._block)] = eng.msa.copy()
            keep._block += 1
            return block0(eng, rows)

        def _resident_keep(get):
            if keep._sweep in keep.resident_sweeps \
                    and keep._block in keep.resident_blocks:
                # a copy: on the CPU the tensor's numpy view is the state
                keep.at[(keep._sweep, keep._block)] = np.array(get())
            keep._block += 1

        def rsweep(eng):
            keep._sweep += 1
            out = rsweep0(eng)
            if keep._sweep in keep.resident_sweeps:
                keep.at[(keep._sweep, "end")] = np.array(
                    eng.best_snapshot())
            return out

        def _try_sweep(eng, extra_exact=()):
            keep._block = 0
            return try0(eng, extra_exact)

        def block_step(msa_d, counts_d, rows, lengths, ncols, **kw):
            _resident_keep(lambda: msa_d[:, :ncols].cpu().numpy())
            return step0(msa_d, counts_d, rows, lengths, ncols, **kw)

        def _exact_block(eng, rows, pending):
            _resident_keep(eng._fetch_msa_host)
            return exact0(eng, rows, pending)

        self._saved = [(BR, "_sweep", sweep0), (BR, "_realign_block", block0),
                       (D, "sweep", rsweep0), (D, "_try_sweep", try0),
                       (D, "_exact_block", exact0), (rd, "block_step", step0)]
        BR._sweep, BR._realign_block = _sweep, _realign_block
        D.sweep, D._try_sweep, D._exact_block = rsweep, _try_sweep, _exact_block
        rd.block_step = block_step
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self._saved:
            setattr(obj, name, orig)
        self._saved = []
        return False
