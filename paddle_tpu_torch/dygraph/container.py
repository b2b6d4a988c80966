"""Layer containers: Sequential, LayerList, ParameterList (a copy of
``paddle_tpu/dygraph/container.py``)."""
from .layers import Layer


class Sequential(Layer):
    """Chain of sublayers called in order (reference container.py
    Sequential). Accepts Layer positional args or (name, layer)
    pairs."""

    def __init__(self, *layers):
        super().__init__()
        for i, item in enumerate(layers):
            if isinstance(item, (list, tuple)):
                name, layer = item
            else:
                name, layer = str(i), item
            self.add_sublayer(name, layer)

    def __getitem__(self, name):
        if isinstance(name, slice):
            return list(self._sub_layers.values())[name]
        if isinstance(name, int):
            return list(self._sub_layers.values())[name]
        return self._sub_layers[name]

    def __setitem__(self, name, layer):
        self.add_sublayer(str(name), layer)

    def __delitem__(self, name):
        del self._sub_layers[str(name)]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    """Indexable list of sublayers (reference container.py LayerList);
    registers each so parameters() sees them."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in (sublayers or []):
            self.append(layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._sub_layers.values())
        layers.insert(index, sublayer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._sub_layers.values())[idx]
        return self._sub_layers[str(idx)]

    def __setitem__(self, idx, sublayer):
        self._sub_layers[str(idx)] = sublayer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    """Indexable list of Parameters (reference container.py
    ParameterList)."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in (parameters or []):
            self.append(p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
