from .seq2seq import Bridge, RNNDecoder, RNNEncoder, Seq2seq

__all__ = ["Bridge", "RNNDecoder", "RNNEncoder", "Seq2seq"]
