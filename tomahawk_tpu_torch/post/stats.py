"""Summary statistics of a .two file (reference: lib/stats.h:100-150):
r2 histogram in percent bins, FLAG-bit tallies, histograms of the four
haplotype counts, and a contig-by-contig record-count matrix."""

import sys

import numpy as np

from ..io.two import TwoReader


def stats_two(path: str, bins: int = 10, out=None):
    out = out or sys.stdout
    r = TwoReader(path)
    n_samples = r.header.n_samples
    two_n = 2 * n_samples

    r2_sum = np.zeros(101)
    r2_cnt = np.zeros(101, np.int64)
    flag_cnt = np.zeros(16, np.int64)
    # sized 2N like the reference's h1..h4 (stats.h:106-109) — rows are
    # counts 0 .. 2N-1; a cell count of exactly 2N cannot pass the
    # minor-count filters, so the reference never indexes (or
    # overflows) that last slot
    hap_hist = np.zeros((4, two_n), np.int64)
    n_contigs = max(r.header.n_contigs, 1)
    cmatrix = np.zeros((n_contigs, n_contigs), np.int64)

    import os as _os
    for recs in r.blocks(threads=min(4, _os.cpu_count() or 1)):
        # bincount, not np.add.at: ufunc.at is an order of magnitude
        # slower for dense histogram accumulation
        b = np.clip((recs["R2"] * 100).astype(np.int64), 0, 100)
        r2_sum += np.bincount(b, weights=recs["R2"], minlength=101)
        r2_cnt += np.bincount(b, minlength=101)
        for j in range(16):
            flag_cnt[j] += int(((recs["controller"] &
                                 (1 << j)) != 0).sum())
        for c in range(4):
            v = np.clip(recs["cnt"][:, c].astype(np.int64), 0, two_n - 1)
            hap_hist[c] += np.bincount(v, minlength=two_n)
        flat = (np.clip(recs["ridA"], 0, n_contigs - 1).astype(np.int64)
                * n_contigs
                + np.clip(recs["ridB"], 0, n_contigs - 1))
        cmatrix += np.bincount(
            flat, minlength=n_contigs * n_contigs
        ).reshape(n_contigs, n_contigs)
    r.close()

    for i in range(101):
        out.write(f"{i}\t{r2_sum[i]:.6g}\t{r2_cnt[i]}\n")
    for j in range(16):
        out.write(f"{j}\t{flag_cnt[j]}\n")
    for v in range(two_n):
        out.write(f"{v}\t{hap_hist[0][v]}\t{hap_hist[1][v]}\t"
                  f"{hap_hist[2][v]}\t{hap_hist[3][v]}\n")
    names = [c.name for c in r.header.contigs] or ["0"]
    out.write("contig\t" + "\t".join(names) + "\n")
    for i, nm in enumerate(names):
        out.write(nm + "\t" + "\t".join(str(x) for x in cmatrix[i]) + "\n")
    return dict(r2_sum=r2_sum, r2_cnt=r2_cnt, flags=flag_cnt,
                hap_hist=hap_hist, cmatrix=cmatrix)
