"""Job kind ``correct_reads``: the error corrector as the error_correction
stage calls it, ``hammer.correct.correct_reads(codes, lengths, k,
quals=quals, device=...)``, on the configuration's reads.

Set-up puts the uncorrected reads, their lengths and qualities on the
card; they stay there and every job starts from them. The warm-up is one
full-size job. The first job's corrected reads are kept on the card;
each later job's are compared with them there, and kept too where they
differ, so that the check judges every distinct answer of the window.
"""

from __future__ import annotations

import torch


class Job:
    def __init__(self, run, tmp: str):
        self.run = run
        self.traffic = run.cell.traffic
        self.inputs = None

    def prepare(self) -> None:
        r = self.run.reads
        dev = self.run.device
        self.inputs = (
            torch.from_numpy(r.codes).to(dev),
            torch.full((r.codes.shape[0],), r.codes.shape[1],
                       dtype=torch.int32, device=dev),
            torch.from_numpy(r.quals).to(dev))

    def _correct(self):
        from spades_for_blackbird_tpu_torch.hammer import correct
        codes, lengths, quals = self.inputs
        return correct.correct_reads(codes, lengths, k=self.traffic["k"],
                                     quals=quals, device=self.run.device)

    def warm_up(self) -> None:
        self._correct()

    def run_one(self, i: int) -> dict:
        corrected, stats = self._correct()
        outputs = self.run.outputs
        if outputs and torch.equal(corrected, outputs[0]["corrected"]):
            corrected = outputs[0]["corrected"]  # the same answer, held once
        return {"corrected": corrected, "stats": stats}

    def release(self) -> None:
        self.inputs = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
