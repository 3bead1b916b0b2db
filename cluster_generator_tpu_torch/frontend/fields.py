"""yt field definitions for the chunked-grid datasets: velocity =
momentum / density, the ideal-gas temperature, and the gas, dark_matter
and stellar aliases."""

from __future__ import annotations

from yt.fields.field_info_container import FieldInfoContainer
from yt.utilities.physical_constants import kboltz, mh

b_units = "code_magnetic"
pres_units = "code_mass/(code_length*code_time**2)"
rho_units = "code_mass / code_length**3"
mom_units = "code_mass/(code_length**2 * code_time)"

_FLUID = "cluster_generator"


def _velocity_field(axis):
    def _velocity(field, data):
        return (data[_FLUID, f"momentum_density_{axis}"]
                / data[_FLUID, "density"])

    return _velocity


def _specific_thermal_energy(field, data):
    return 1.5 * (data[_FLUID, "pressure"] / data[_FLUID, "density"])


def _temperature(field, data):
    return ((data["gas", "pressure"] / data["gas", "density"])
            * data.ds.mu * mh / kboltz)


class ClusterGeneratorFieldInfo(FieldInfoContainer):
    known_other_fields = (
        ("density", (rho_units, ["density"], None)),
        ("momentum_density_x", (mom_units, [], None)),
        ("momentum_density_y", (mom_units, [], None)),
        ("momentum_density_z", (mom_units, [], None)),
        ("pressure", (pres_units, ["pressure"], None)),
        ("stellar_density", (rho_units, [], None)),
        ("dark_matter_density", (rho_units, [], None)),
        ("magnetic_pressure", (pres_units, [], None)),
    )

    known_particle_fields = ()

    def setup_fluid_fields(self):
        unit_system = self.ds.unit_system
        velocity = unit_system["velocity"]
        mom = "code_mass/code_time/code_length**2"

        for comp in self.ds.coordinates.axis_order:
            vel_field = (_FLUID, f"velocity_{comp}")
            mom_field = (_FLUID, f"momentum_density_{comp}")
            self.add_output_field(mom_field, sampling_type="cell", units=mom)
            self.add_field(vel_field, sampling_type="cell",
                           function=_velocity_field(comp), units=velocity)
            self.alias(("gas", f"momentum_density_{comp}"), mom_field,
                       units=mom)
            for ftype in ("gas", "dark_matter", "stellar"):
                self.alias((ftype, f"velocity_{comp}"), vel_field,
                           units=velocity)

        self.alias(("gas", "pressure"), (_FLUID, "pressure"),
                   units=unit_system["pressure"])
        self.alias(("dark_matter", "density"),
                   (_FLUID, "dark_matter_density"),
                   units=unit_system["density"])
        self.alias(("stellar", "density"), (_FLUID, "stellar_density"),
                   units=unit_system["density"])
        self.add_field(("gas", "specific_thermal_energy"),
                       sampling_type="cell",
                       function=_specific_thermal_energy,
                       units=unit_system["specific_energy"])
        self.add_field(("gas", "temperature"), sampling_type="cell",
                       function=_temperature,
                       units=unit_system["temperature"])

    def setup_particle_fields(self, ptype):
        super().setup_particle_fields(ptype)
