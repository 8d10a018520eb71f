"""HAConvDR: a conversational dense-retrieval framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the HAConvDR
research pipeline (history-aware conversational dense retrieval, ACL 2024
Findings): conversational datasets -> pseudo relevance judgments (PRJ) over
history -> BM25 + history hard negatives -> contrastive fine-tuning of an
ANCE (RoBERTa-base) query encoder against a frozen passage encoder ->
corpus embedding over a device mesh -> exact blocked inner-product top-k
search with on-device merge -> TREC output + IR metrics.

Layers (mirrors reference layer map, see SURVEY.md SS1):
  preprocess/  L0  dataset preprocessing pipelines (TopiOCQA, QReCC)
  mine/        L1  PRJ labeling, L2 BM25 hard-negative mining (native C++ core)
  models/      L3  ANCE / BERT dual encoders (flax), HF-torch checkpoint import
  index/       L4  tokenized corpus store + sharded embedding blocks + build
  train/       L5  contrastive training step under jit/pjit
  ops/, eval/  L6  blocked top-k search kernels + TREC metrics
  parallel/        mesh/sharding utilities, sharded search & encode
"""

__version__ = "0.1.0"
