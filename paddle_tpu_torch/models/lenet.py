"""LeNet-5 for MNIST (a copy of ``paddle_tpu/models/lenet.py``; BASELINE
config 1): two conv + relu + max-pool stages and a softmax classifier,
trained through ``Executor.run`` with Adam or SGD."""
from .. import layers
from .. import optimizer as optim
from ..framework.core import Program, program_guard


def lenet(images, label, class_num=10):
    """Returns (avg_loss, acc, prediction)."""
    conv1 = layers.conv2d(images, num_filters=20, filter_size=5,
                          act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5,
                          act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    prediction = layers.fc(pool2, size=class_num, act="softmax")
    loss = layers.cross_entropy(prediction, label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(prediction, label)
    return avg_loss, acc, prediction


def build_lenet_train(lr=0.001, optimizer="adam"):
    """Build (main, startup, feed names, [avg_loss, acc]) training
    programs; ``optimizer`` "adam", or anything else for SGD."""
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        images = layers.data("img", [-1, 1, 28, 28], "float32")
        label = layers.data("label", [-1, 1], "int64")
        avg_loss, acc, _ = lenet(images, label)
        if optimizer == "adam":
            opt = optim.Adam(learning_rate=lr)
        else:
            opt = optim.SGD(learning_rate=lr)
        opt.minimize(avg_loss)
    return main, startup, ["img", "label"], [avg_loss, acc]
