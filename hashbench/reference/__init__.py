"""The plain reference that decides `correct`.

`keys` works out the key stream from the seed; one module a hash family
(`multilinear`, `gf_multilinear`), found by the family's name, gives each
row's K 64-bit surfaces and 32-bit hashes under the variable-length rule;
`probes` reduces a surface mod m and sizes the Bloom filter. Plain numpy
and PyTorch on int64 tensors that carry u64 bits: nothing here imports
the program under test or the JAX package.
"""
