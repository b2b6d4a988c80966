"""Dygraph learning-rate schedulers (a copy of
``paddle_tpu/dygraph/learning_rate_scheduler.py``): LearningRateDecay,
PiecewiseDecay, NaturalExpDecay, ExponentialDecay, InverseTimeDecay,
PolynomialDecay, CosineDecay, NoamDecay, LinearLrWarmup and
ReduceLROnPlateau. A scheduler is a callable the optimizer calls once per
``minimize()``; each call advances the step counter and returns the LR as
a host float. Under ``jit_step`` the LR is frozen at capture."""
import math


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return float(lr)

    def step(self):
        raise NotImplementedError

    # checkpoint parity with reference state_dict keys
    def state_dict(self):
        return {"step_num": self.step_num}

    def set_dict(self, d):
        self.step_num = int(d.get("step_num", self.step_num))
    set_state_dict = set_dict


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[-1]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        n = self.step_num
        decay = self.decay_steps
        if self.cycle:
            div = max(1.0, math.ceil(n / decay))
            decay = div * decay
        else:
            n = min(n, decay)
        frac = (1.0 - n / decay) ** self.power
        return (self.learning_rate - self.end_learning_rate) * frac + \
            self.end_learning_rate


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return 0.5 * self.learning_rate * (
            math.cos(epoch * math.pi / self.epochs) + 1.0)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32", learning_rate=1.0):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.learning_rate = learning_rate

    def step(self):
        n = max(self.step_num, 1)
        a = n ** -0.5
        b = n * (self.warmup_steps ** -1.5)
        return self.learning_rate * (self.d_model ** -0.5) * min(a, b)


class LinearLrWarmup(LearningRateDecay):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 begin=1, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr

    def step(self):
        if self.step_num < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                (self.step_num / self.warmup_steps)
        lr = self.learning_rate
        return lr() if callable(lr) else lr


class ReduceLROnPlateau(LearningRateDecay):
    """Reduce LR when a metric plateaus (reference 2.0-preview API)."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, eps=1e-8, verbose=False, dtype="float32"):
        super().__init__(0, 1, dtype)
        assert mode in ("min", "max")
        self.learning_rate = float(learning_rate)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.verbose = verbose
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def state_dict(self):
        return {"learning_rate": self.learning_rate, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def set_dict(self, d):
        self.learning_rate = float(d.get("learning_rate",
                                         self.learning_rate))
        self.best = d.get("best", self.best)
        self.num_bad_epochs = int(d.get("num_bad_epochs",
                                        self.num_bad_epochs))
        self.cooldown_counter = int(d.get("cooldown_counter",
                                          self.cooldown_counter))
    set_state_dict = set_dict

    def __call__(self):
        return self.learning_rate

    def _better(self, current, best):
        if self.threshold_mode == "rel":
            delta = abs(best) * self.threshold
        else:
            delta = self.threshold
        if self.mode == "min":
            return current < best - delta
        return current > best + delta

    def step(self, metric):
        current = float(metric.numpy() if hasattr(metric, "numpy")
                        else metric)
        if self.best is None or self._better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        elif self.num_bad_epochs > self.patience:
            new_lr = max(self.learning_rate * self.factor, self.min_lr)
            if self.learning_rate - new_lr > self.eps:
                self.learning_rate = new_lr
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.6g}")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
