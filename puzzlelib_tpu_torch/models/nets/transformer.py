"""Transformer encoder classifier (counterpart of
``puzzlelib_tpu/models/nets/transformer.py``).

Pre-norm: emb -> N x [LN -> MHA -> +res, LN -> MLP -> +res] -> LN ->
mean-pool -> classifier, as a ``Graph`` with the reference's node and
variable names, so a parameter table of the JAX package's net loads here
(``convert.paramsFromNumpy``).
"""

from puzzlelib_tpu_torch.containers import Graph, Sequential
from puzzlelib_tpu_torch.modules import (
    Embedder, LayerNorm, MultiHeadAttention, Linear, Gelu, Reshape, Add, Sum, MulAddConst
)


def _mlp(seq, emb, hidden, name):
    block = Sequential(name=name)
    block.append(Reshape((-1, emb), showWarnings=False))
    block.append(Linear(emb, hidden, initscheme=("xavier", "avg")))
    block.append(Gelu())
    block.append(Linear(hidden, emb, initscheme=("xavier", "avg")))
    block.append(Reshape((-1, seq, emb), showWarnings=False))
    return block


def buildTransformerClassifier(vocabsize, seqlen, embsize, nheads=4, nlayers=2, nclasses=2,
                               mlpRatio=4, causal=False, attnAlgo="xla", name="transformer"):
    """Token ids (batch, seqlen) int32 -> logits (batch, nclasses)."""
    inp = Embedder(vocabsize, seqlen, embsize, initscheme="uniform", wscale=0.1, name="embed").node()

    node = inp
    for i in range(nlayers):
        attn = Sequential(name="attn%d" % i)
        attn.append(LayerNorm(embsize))
        attn.append(MultiHeadAttention(embsize, nheads, causal=causal,
                                       initscheme=("xavier", "avg"), attnAlgo=attnAlgo))
        attnNode = attn.node(node)
        node = Add(name="res_attn%d" % i).node(node, attnNode)

        mlpNode = Sequential(name="mlpblock%d" % i)
        mlpNode.append(LayerNorm(embsize))
        mlpNode.extend(_mlp(seqlen, embsize, mlpRatio * embsize, name="mlp%d" % i))
        mlpNode = mlpNode.node(node)
        node = Add(name="res_mlp%d" % i).node(node, mlpNode)

    head = Sequential(name="head")
    head.append(LayerNorm(embsize))
    head.append(Sum(axis=1, useWeights=False))
    head.append(MulAddConst(a=1.0 / seqlen, b=0.0))
    head.append(Linear(embsize, nclasses, initscheme=("xavier", "avg")))
    out = head.node(node)

    return Graph(inputs=inp, outputs=out, name=name)
