"""Loss layers (trimmed copy of ``paddle_tpu/layers/loss.py``):
``cross_entropy``, ``softmax_with_cross_entropy``, ``square_error_cost``
(``:33``), ``sigmoid_cross_entropy_with_logits`` (``:42``),
``smooth_l1``, ``log_loss``, ``huber_loss``, ``kldiv_loss`` and
``mse_loss`` (``:53-103``)."""
from .layer_helper import LayerHelper


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """``cross_entropy`` over probabilities (e.g. a softmax's output)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(type="smooth_l1_loss",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]}, attrs={"epsilon": epsilon})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    residual = helper.create_variable_for_type_inference(
        dtype=input.dtype, stop_gradient=True)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="kldiv_loss",
                     inputs={"X": [x], "Target": [target]},
                     outputs={"Loss": [out]},
                     attrs={"reduction": reduction})
    return out


def mse_loss(input, label):
    helper = LayerHelper("mse_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="mse_loss",
                     inputs={"Input": [input], "Label": [label]},
                     outputs={"Out": [out]})
    return out
