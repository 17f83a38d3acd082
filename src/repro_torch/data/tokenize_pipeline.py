"""File names of a packed token dataset (the suffix constants of
``repro.data.tokenize_pipeline``).  The producer-consumer tokenization
pipeline itself is not ported yet; the port reads datasets that the JAX
package's pipeline or ``packed_dataset.synthetic_dataset`` wrote."""

TOKENS_SUFFIX = ".tokens.u32"
DOCIDX_SUFFIX = ".docidx.npy"
