from .records import ChainPair, Partition
from .reader import ingest, load_chains, parse_chain_file, resolve_chain_files
from .nested import load_nested_chains, nested_kind, sampler_lnz
from . import preprocess
