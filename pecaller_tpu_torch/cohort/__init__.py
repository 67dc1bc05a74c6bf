"""The cohort tail: snplist, merger, indel consensus, VCF and QC
counters (JAX-free host code, a copy of ``pecaller_tpu/cohort``)."""

from .merger import run_merger
from .indel import merge_indel_snp
from .vcf import snp_to_vcf
from .snplist import make_snplist, make_snplist_restricted
from .qc import snp_tran_counter, snp_tran_silent_rep

__all__ = ["run_merger", "merge_indel_snp", "snp_to_vcf", "make_snplist", "make_snplist_restricted",
           "snp_tran_counter", "snp_tran_silent_rep"]
