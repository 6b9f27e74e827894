"""Variant search / genotyping (reference: ``bigsi/cmds/variant_search.py``).

Probe generation shells out to the external ``mykrobe variants
make-probes`` tool (optional dependency, exactly as in the reference at
``variant_search.py:45-58``); the genotyping logic — exact search of
ref/alt probes, classify samples 0/0, 0/1, 1/1 — is implemented here.
"""

from __future__ import annotations

import logging
import os
import subprocess
import tempfile

from bigsi_tpu_torch.io.fasta import read_fasta

logger = logging.getLogger(__name__)


class BIGSIVariantSearch:
    def __init__(self, bigsi, reference):
        self.bigsi = bigsi
        self.reference = reference

    def create_variant_probe_set(self, var_name: str) -> bytes:
        return subprocess.check_output(
            [
                "mykrobe",
                "variants",
                "make-probes",
                "-k",
                str(self.bigsi.kmer_size),
                "-v",
                var_name,
                self.reference,
            ]
        )

    def _split_probes(self, fasta_string: bytes):
        with tempfile.NamedTemporaryFile(suffix=".fasta", delete=False) as fp:
            fp.write(fasta_string)
            path = fp.name
        try:
            fasta = read_fasta(path)
        finally:
            os.unlink(path)
        refs, alts = [], []
        for name, seq in fasta.items():
            (refs if "ref" in name else alts).append(str(seq))
        return refs, alts

    def search(self, ref_base, pos, alt_base="X") -> dict:
        var_name = "".join([ref_base, str(pos), alt_base])
        refs, alts = self._split_probes(self.create_variant_probe_set(var_name))
        return {"query": var_name, "results": self.genotype_alleles(refs, alts)}

    def _matching_samples(self, probe_seqs) -> set:
        """Samples matching ANY of the probes exactly (threshold 1)."""
        names = set()
        for seq in probe_seqs:
            names.update(
                r["sample_name"] for r in self.bigsi.search(seq, 1, score=False)
            )
        return names

    def genotype_alleles(self, refs, alts) -> list:
        """Classify each sample hit by which allele probes it carries:
        ref only -> 0/0, both -> 0/1, alt only -> 1/1
        (reference semantics: ``bigsi/cmds/variant_search.py:60-73``;
        output here is name-sorted where the reference iterates a set)."""
        ref_hits = self._matching_samples(refs)
        alt_hits = self._matching_samples(alts)
        calls = {}
        for name in ref_hits | alt_hits:
            in_ref, in_alt = name in ref_hits, name in alt_hits
            calls[name] = "0/1" if (in_ref and in_alt) else (
                "0/0" if in_ref else "1/1"
            )
        return [
            {"sample_name": name, "genotype": calls[name]}
            for name in sorted(calls)
        ]


class BIGSIAminoAcidMutationSearch(BIGSIVariantSearch):
    def __init__(self, bigsi, reference, genbank):
        super().__init__(bigsi, reference)
        self.genbank = genbank

    def create_variant_probe_set(self, var_name: str) -> bytes:
        return subprocess.check_output(
            [
                "mykrobe",
                "variants",
                "make-probes",
                "-k",
                str(self.bigsi.kmer_size),
                "-v",
                var_name,
                "-g",
                self.genbank,
                self.reference,
            ]
        )

    def search(self, gene, ref, pos, alt) -> dict:
        mut_name = "".join([ref, str(pos), alt])
        gene_mut_name = "_".join([gene, mut_name])
        refs, alts = self._split_probes(self.create_variant_probe_set(gene_mut_name))
        return {"query": gene_mut_name, "results": self.genotype_alleles(refs, alts)}
