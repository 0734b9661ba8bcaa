"""NLP / embeddings (counterpart of deeplearning4j_tpu/nlp).

Parity surface: the reference's deeplearning4j-nlp -- the SequenceVectors
framework, Word2Vec, ParagraphVectors, GloVe, vocabulary construction,
tokenization, sentence iteration and WordVectorSerializer.

Training is batched: (center, context, negatives) index arrays are built
on the host with the JAX package's numpy draws, and the embedding tables
live on the device (the card unless ``device=`` says otherwise), where
each batch is gathers, dot products and accumulating scatter-adds in
plain tensor code. No hand kernel runs here: the JAX package trains these
tables with ``jnp`` and no Pallas.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, NGramTokenizerFactory, CJKTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator, BasicLineIterator, FileSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, VocabWord,
                                                VocabConstructor)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.distributed_word2vec import \
    DistributedWord2Vec
from deeplearning4j_tpu_torch.nlp.cnn_sentence_iterator import (
    CnnSentenceDataSetIterator, UnknownWordHandling,
)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer

__all__ = ["DefaultTokenizerFactory", "NGramTokenizerFactory",
           "CJKTokenizerFactory",
           "CollectionSentenceIterator", "BasicLineIterator",
           "FileSentenceIterator", "VocabCache", "VocabWord",
           "VocabConstructor", "Word2Vec", "DistributedWord2Vec",
           "CnnSentenceDataSetIterator", "UnknownWordHandling",
           "ParagraphVectors", "Glove", "WordVectorSerializer"]
