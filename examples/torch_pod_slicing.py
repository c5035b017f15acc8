"""GWTF on the production target: flow-routed pipeline placement over
slices of a 16 x 16 pod of H100s, with preemption repair (the port of
``examples/pod_slicing.py``; numpy only, no device).

    PYTHONPATH=src python examples/torch_pod_slicing.py
"""
from repro_torch.configs import get_config
from repro_torch.core.podmap import carve_pod, lose_slice, schedule_pipelines


def main():
    cfg = get_config("gemma-7b")
    slices = carve_pod((16, 16), (4, 4))
    print(f"pod 16x16 carved into {len(slices)} slices of 4x4 cards")

    proto, net = schedule_pipelines(cfg, num_stages=5)
    flows = proto.complete_flows()
    print(f"\n{cfg.name}: {len(flows)} pipeline flows across 5 stages")
    for f in flows[:4]:
        hops = " -> ".join(f"slice{n}" for n in f)
        print("  ", hops)
    print(f"  max edge cost: {proto.max_edge_cost()*1e3:.2f} ms "
          f"(compute+link per microbatch hop)")

    victim = flows[0][2]
    print(f"\npreempting slice {victim} (on flow 0)...")
    new_flows = lose_slice(proto, net, victim)
    print(f"repaired: {len(new_flows)} flows, none through slice {victim}: "
          f"{all(victim not in f for f in new_flows)}")
    print(f"  max edge cost after repair: {proto.max_edge_cost()*1e3:.2f} ms")


if __name__ == "__main__":
    main()
