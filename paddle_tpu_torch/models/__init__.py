"""Models of the port (paddle_tpu/models counterpart)."""

from paddle_tpu_torch.models.convert import (load_jax_opt_state,
                                             load_jax_params, to_jax_opt_state,
                                             to_jax_params)
from paddle_tpu_torch.models.nlp import (DeepFM, Recommender, Seq2Seq,
                                         TextClassifier, Word2Vec)
from paddle_tpu_torch.models.transformer import (BertEncoder, CausalLM,
                                                 DecoderLayer, EncoderLayer,
                                                 MultiHeadAttention,
                                                 Transformer, init_kv_caches)
from paddle_tpu_torch.models.vision import (MLP, AlexNet, GoogLeNet, LeNet,
                                            ResNet, SEResNeXt, VGG, resnet50,
                                            se_resnext50, vgg16)

__all__ = ["AlexNet", "BertEncoder", "CausalLM", "DecoderLayer", "DeepFM",
           "EncoderLayer", "GoogLeNet", "LeNet", "MLP", "MultiHeadAttention",
           "Recommender", "ResNet", "SEResNeXt", "Seq2Seq", "TextClassifier",
           "Transformer", "VGG", "Word2Vec", "init_kv_caches",
           "load_jax_opt_state", "load_jax_params", "resnet50",
           "se_resnext50", "to_jax_opt_state", "to_jax_params", "vgg16"]
