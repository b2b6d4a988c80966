"""fluid.nets: composite network helpers, a copy of
``paddle_tpu/nets.py`` (``simple_img_conv_pool``, ``img_conv_group``,
``sequence_conv_pool``, ``glu``, ``scaled_dot_product_attention``)
built from the port's layers."""
import numpy as np

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """VGG-style conv block: N x (conv [+ BN] [+ dropout]) + one pool."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return v if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(conv_num_filter)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(tmp, conv_num_filter[i], conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(tmp, dropout_prob=drop_rate)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, length=None,
                       param_attr=None, act="sigmoid", pool_type="max",
                       bias_attr=None):
    """sequence_conv + sequence_pool (masked-dense: pass `length` [B])."""
    conv_out = layers.sequence_conv(input, num_filters, filter_size,
                                    param_attr=param_attr, act=act,
                                    bias_attr=bias_attr, length=length)
    return layers.sequence_pool(conv_out, pool_type=pool_type,
                                length=length)


def glu(input, dim=-1):
    """Gated linear unit: split in half on `dim`, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, L, D] tensors
    (reference nets.py:360). Returns [B, Lq, D_v]."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[-2] != values.shape[-2] if None not in (
            keys.shape, values.shape) else False:
        raise ValueError("keys and values must share the sequence length")

    def split_heads(x):
        if num_heads == 1:
            return x
        B, L, D = x.shape
        x = layers.reshape(x, [B, L, num_heads, D // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        B, H, L, Dh = x.shape
        return layers.reshape(layers.transpose(x, [0, 2, 1, 3]),
                              [B, L, H * Dh])

    q = split_heads(queries)
    k = split_heads(keys)
    v = split_heads(values)
    d_key = queries.shape[-1] // num_heads
    scores = layers.matmul(q, k, transpose_y=True,
                           alpha=1.0 / float(np.sqrt(d_key)))
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(
            weights, dropout_prob=dropout_rate,
            dropout_implementation="upscale_in_train")
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)


__all__ = ["simple_img_conv_pool", "img_conv_group",
           "sequence_conv_pool", "glu", "scaled_dot_product_attention"]
