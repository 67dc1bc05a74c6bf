"""Host ms a batch of the port's ``FastqBatcher`` parsing the sample's
gzip FASTQ pair in set-up."""


def read(rec):
    return 1e3 * rec["fastq_s"] / rec["n_batches"]
