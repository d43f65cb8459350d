"""The archive of a `calc` cell: stacked phased planes written as VCF
text (the copy of the port's chip_smoke.write_vcf: `a|b` genotypes of
one contig, REF A, ALT C, POS the variant's position + 1), built a
super-block at a time on the device."""

import torch

from ldbench.traffic import _pack

CONTIG = "6"


def write(path: str, stacked: dict, n_samples: int, device) -> int:
    """Write `stacked`'s valid variants to `path`; returns the bytes."""
    n_hap = 2 * n_samples
    head = (b"##fileformat=VCFv4.2\n"
            b"##contig=<ID=" + CONTIG.encode() + b",length=171115067>\n"
            b'##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
            b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(f"S{i}" for i in range(n_samples)).encode() + b"\n")
    size = 0
    with open(path, "wb") as fh:
        fh.write(head)
        size += len(head)
        for s in range(len(stacked["n_rec"])):
            n = int(stacked["n_rec"][s])
            words = torch.from_numpy(stacked["alt_bits"][s][:n].view(
                "int32")).to(device)
            alt = _pack.unpack(words, n_hap).to(torch.uint8)
            cells = torch.empty((n, n_samples, 4), dtype=torch.uint8,
                                device=device)
            cells[:, :, 0] = ord("0") + alt[:, 0::2]
            cells[:, :, 1] = ord("|")
            cells[:, :, 2] = ord("0") + alt[:, 1::2]
            cells[:, :, 3] = ord("\t")
            cells[:, -1, 3] = ord("\n")
            cells = cells.cpu().numpy()
            pos = stacked["pos"][s][:n]
            for r in range(n):
                line = (f"{CONTIG}\t{int(pos[r]) + 1}\t.\tA\tC\t.\tPASS\t.\t"
                        "GT\t")
                fh.write(line.encode())
                fh.write(cells[r].tobytes())
                size += len(line) + cells[r].nbytes
    return size
